"""Compute IR: the op sequence inside (and before) the training loop.

Clean-room Python equivalent of the reference's Compute IR
(reference: src/ir/compute.h — OpType/ComputeOp enums at :25-64,
ComputeNode :74-160, ForwardNode :163, TrainingLoopNode :174-221).
Nodes reference DataNode placeholders from gala_tpu.ir.data_ir; the four
middle-end passes (gala_tpu.passes) rewrite the node list in place, and
lowering (gala_tpu.lowering) interprets it into a jitted JAX program.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

from gala_tpu.ir.data_ir import DataNode

_ids = itertools.count()


class LossFunction(enum.Enum):
    CROSS_ENTROPY = "cross_entropy"


class Optimizer(enum.Enum):
    ADAM = "adam"


class OpType(enum.Enum):
    # reference: src/ir/compute.h:25-31
    POINTWISE = "pointwise"
    AGGREGATE_EDGE = "aggregate_edge"    # SDDMM/SDDVV-based
    AGGREGATE_NODE = "aggregate_node"    # SpMM-based
    UPDATE_EDGE = "update_edge"          # edge softmax etc.
    UPDATE_NODE = "update_node"          # FFN / nonlinearity


class ComputeOp(enum.Enum):
    # reference: src/ir/compute.h:33-64
    LOAD = "load"
    DEGREES = "degrees"
    POWER = "power"
    APPLY_EDGES = "apply_edges"                  # SDDMM
    AGGREGATE_MUL_SUM = "aggregate_mul_sum"      # SpMM (autograd)
    AGGREGATE_EDGE_SUM = "aggregate_edge_sum"    # SDDVV add (GAT logits)
    AGGREGATE_EDGE_MUL = "aggregate_edge_mul"    # SDDVV mul (sparsity rewrite)
    AGGREGATE_MUL_SUM_DIRECT = "aggregate_mul_sum_direct"  # no autograd
    FFN = "ffn"
    FFN_EDGE = "ffn_edge"
    FFN_SELF = "ffn_self"
    FFN_REPEAT = "ffn_repeat"          # re-applied FFN (sparsity rewrite)
    BIAS = "bias"
    RELU = "relu"
    LOG_SOFTMAX = "log_softmax"
    SOFTMAX = "softmax"                # edge softmax when UPDATE_EDGE
    LEAKY_RELU = "leaky_relu"
    ROW_BROADCAST = "row_broadcast"    # norm * X
    SCALAR_ADD_EPS_MULTIPLY = "scalar_add_eps_multiply"  # (1+eps)*X, eps learned
    ADD = "add"
    MUL = "mul"
    TRANSFORM = "transform"
    ONES = "ones"
    EPSILON = "epsilon"
    FULL = "full"
    # fusion product added here (gala_tpu.passes.attention_fusion):
    # SDDVV-add + leaky-relu + edge-softmax + SpMM-with-values as one
    # slot-space op (gala_tpu.ops.attention)
    FUSED_ATTENTION = "fused_attention"


class CompOpt(enum.Enum):
    # reference: src/ir/compute.h:66-70
    COARSEN = "coarsen"
    SAMPLE = "sample"
    SAMPLE_DYNAMIC = "sample_dynamic"


@dataclasses.dataclass
class ComputeNode:
    """One forward op.  `params` carries op constants (power exponent,
    leaky-relu slope, eps init, dataset name...)."""

    op_type: OpType
    op: ComputeOp
    inputs: list[DataNode] = dataclasses.field(default_factory=list)
    outputs: list[DataNode] = dataclasses.field(default_factory=list)
    params: list[str] = dataclasses.field(default_factory=list)
    opts: list[tuple[CompOpt, float]] = dataclasses.field(default_factory=list)
    kernel_name: str = ""
    layer: int = -1                 # originating layer (graph-slot index)
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    def add_opt(self, opt: CompOpt, param: float) -> None:
        self.opts.append((opt, param))

    def get_opt(self, opt: CompOpt) -> Optional[float]:
        for o, p in self.opts:
            if o == opt:
                return p
        return None

    def input_named(self, name: str) -> Optional[DataNode]:
        for d in self.inputs:
            if d.name == name:
                return d
        return None

    @property
    def output(self) -> DataNode:
        return self.outputs[0]

    def __hash__(self):
        return self.uid

    def __eq__(self, other):
        return isinstance(other, ComputeNode) and other.uid == self.uid


@dataclasses.dataclass
class TrainingLoop:
    """The training loop body (reference: src/ir/compute.h:174-221)."""

    iters: int
    valid_step: int = 0
    loss: LossFunction = LossFunction.CROSS_ENTROPY
    optimizer: Optimizer = Optimizer.ADAM
    lr: float = 0.01
    weight_decay: float = 5e-4
    nodes: list[ComputeNode] = dataclasses.field(default_factory=list)

    # list-surgery helpers used by the middle-end passes
    def swap(self, i: int, j: int) -> None:
        self.nodes[i], self.nodes[j] = self.nodes[j], self.nodes[i]

    def insert(self, i: int, node: ComputeNode) -> None:
        self.nodes.insert(i, node)

    def erase(self, i: int, n: int = 1) -> None:
        del self.nodes[i : i + n]


@dataclasses.dataclass
class Program:
    """A whole compiled unit: pre-loop nodes (LOAD + hoisted invariants),
    the training loop, and the data-relation graph."""

    pre: list[ComputeNode] = dataclasses.field(default_factory=list)
    loop: TrainingLoop | None = None
    dependencies: list = dataclasses.field(default_factory=list)
    associations: list = dataclasses.field(default_factory=list)
    transforms: list = dataclasses.field(default_factory=list)
    n_layers: int = 0
    uses_training_subgraphs: bool = False

    def all_nodes(self) -> list[ComputeNode]:
        return [*self.pre, *(self.loop.nodes if self.loop else [])]


def uses_fused_attention(prog: Program) -> bool:
    """The attention_fusion pass emitted FUSED_ATTENTION ops."""
    return any(n.op is ComputeOp.FUSED_ATTENTION for n in prog.all_nodes())


def uses_edge_values(prog: Program) -> bool:
    """The program aggregates with learned/precomputed per-edge values
    (sparse-rewrite product, unfused GAT chain) — the layouts need the
    slot<->edge permutations (spmm_ev paths)."""
    return any(
        n.op in (ComputeOp.AGGREGATE_EDGE_SUM, ComputeOp.AGGREGATE_EDGE_MUL)
        or (n.op is ComputeOp.AGGREGATE_MUL_SUM and len(n.inputs) >= 3)
        for n in prog.all_nodes()
    )


def aggregated_widths(prog: Program, feat_size: int, n_classes: int) -> list[int]:
    """Column widths of every tensor a slot-gathering aggregation sweep
    actually reads, POST-pass (the reorder pass routinely moves a
    shrinking FFN before the aggregation, so e.g. a 260-feature GCN
    aggregates 32/41-wide tensors).  These widths — not the widest layer
    anywhere in the model — are what size the gather table, and with it
    the col_tile memory gate (lowering/lower.py).  Symbolic dims resolve against the bound
    dataset; non-positive leftovers fall back to max(feat, classes)."""
    from gala_tpu.ir.data_ir import SYM_CLASSES, SYM_FEATS

    def resolve(c: int) -> int:
        if c == SYM_FEATS:
            return feat_size
        if c == SYM_CLASSES:
            return n_classes
        return c if c > 0 else max(feat_size, n_classes)

    widths = []
    for n in prog.all_nodes():
        if n.op in (
            ComputeOp.AGGREGATE_MUL_SUM,
            ComputeOp.AGGREGATE_MUL_SUM_DIRECT,
            ComputeOp.FUSED_ATTENTION,
        ):
            feats_in = [d for d in n.inputs if not d.is_graph]
            if feats_in:
                widths.append(resolve(feats_in[0].cols))
    return widths or [max(feat_size, n_classes)]
