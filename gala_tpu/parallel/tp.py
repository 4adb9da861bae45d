"""Tensor parallelism for DSL-compiled programs.

Megatron-style feature-dimension sharding of the FFN weights over the
mesh's 'model' axis, planned automatically from the compute IR: walking
the loop in order, an FFN whose input is replicated gets COLUMN-split
weights (output activations become feature-sharded, no collective); an
FFN whose input is feature-sharded gets ROW-split weights (each model
shard computes a partial product, one psum restores replication).  The
ops BETWEEN a col-split and its closing row-split must be column-
independent — elementwise nonlinearities, row broadcasts, and graph
aggregations all are (SpMM mixes rows, never feature columns), which is
what makes GNN layers TP-friendly: the aggregation's gather/segment-sum
cost divides by the model-axis size too.

The reference has no distributed execution of any kind (reference:
src/codegen/common.h:22-29 Environment enum, unused); this is the
scale-out the SURVEY §2.4 table calls for.

The plan is a {weight_name: 'col' | 'row'} dict.  shard_compiled bakes
it into the ShardedGraph pytree's STATIC aux data (`tp_plan`, a sorted
items tuple so it hashes), and `gala_tpu.lowering.interp` consults it
when lowering FFN ops: 'row' adds the closing psum over MODEL_AXIS;
'col' is a plain local matmul on the pre-split weight.  Carrying the
plan on the graph keeps lowering purely functional — no ambient
context that JAX's lazy/partial retracing could observe stale.
`param_pspecs` gives the matching shard_map in_specs.
"""
from __future__ import annotations

from jax.sharding import PartitionSpec as P

from gala_tpu.ir.compute_ir import ComputeOp, Program

MODEL_AXIS = "model"


_FFN_OPS = (ComputeOp.FFN, ComputeOp.FFN_SELF, ComputeOp.FFN_EDGE,
            ComputeOp.FFN_REPEAT)
# ops that propagate feature-sharding from input to output unchanged
# (column-independent in the feature dimension)
_COLWISE = {
    ComputeOp.RELU, ComputeOp.LEAKY_RELU, ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
}
# (n,1)/edge-sized ops whose operands must be replicated
_NEEDS_REPL = {
    ComputeOp.DEGREES, ComputeOp.POWER, ComputeOp.ONES, ComputeOp.FULL,
    ComputeOp.AGGREGATE_EDGE_SUM, ComputeOp.AGGREGATE_EDGE_MUL,
    ComputeOp.SOFTMAX, ComputeOp.APPLY_EDGES,
    ComputeOp.AGGREGATE_MUL_SUM_DIRECT, ComputeOp.LOG_SOFTMAX,
}


def plan_tp(prog: Program, dim_env: dict[int, int], n_model: int
            ) -> dict[str, str] | None:
    """Assign col/row splits to the program's FFN weights, or None when
    the program cannot be TP-sharded safely (indivisible dims, an op
    that would see mixed shardings, a shared weight with conflicting
    assignments, or a feature-sharded final output)."""
    if n_model <= 1 or prog.loop is None:
        return None

    def rdim(d: int) -> int:
        return dim_env.get(d, d) if d < 0 else d

    splits: dict[str, str] = {}
    sharded: set[int] = set()      # data uids whose feature dim is split

    def assign(name: str, split: str) -> bool:
        if splits.get(name, split) != split:
            return False           # shared weight, conflicting roles
        splits[name] = split
        return True

    for node in prog.loop.nodes:
        op = node.op
        ins_sh = [d.uid in sharded for d in node.inputs]
        if op in _FFN_OPS:
            w = node.inputs[1]
            if ins_sh[0]:
                # close the pair: row-split, psum'd -> replicated out
                if rdim(w.rows) % n_model or not assign(w.name, "row"):
                    return None
            else:
                prev = splits.get(w.name)
                if prev == "row":
                    return None    # shared weight, conflicting roles
                if prev == "col" or (
                    prev is None and rdim(w.cols) % n_model == 0
                ):
                    splits[w.name] = "col"
                    sharded.add(node.outputs[0].uid)
                # else: indivisible output dim (e.g. a 1-wide attention
                # vector) — leave this weight replicated, output stays
                # replicated; the rest of the program can still split
        elif op in _COLWISE:
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.ROW_BROADCAST:
            # inputs [norm(n,1), X]: the broadcast vector must be replicated
            if ins_sh[0]:
                return None
            if ins_sh[1]:
                sharded.add(node.outputs[0].uid)
        elif op in (ComputeOp.ADD, ComputeOp.MUL):
            if ins_sh[0] != ins_sh[1]:
                return None        # sharded + replicated: ill-typed
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.AGGREGATE_MUL_SUM:
            # SpMM is row-mixing, column-independent; edge values (input
            # 3) and the graph are replicated over 'model'
            if any(ins_sh[1:]):
                return None
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.FUSED_ATTENTION:
            # inputs [x, vl, vr]: scores read vl/vr only -> they must be
            # replicated; the aggregation is column-independent in x
            if ins_sh[1] or ins_sh[2]:
                return None
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op in _NEEDS_REPL:
            if any(ins_sh):
                return None
        else:
            if any(ins_sh):
                return None        # unknown op: stay conservative
    if not splits:
        return None
    last = prog.loop.nodes[-1]
    if last.outputs and last.outputs[0].uid in sharded:
        return None                # logits must come out replicated
    return splits


def param_pspecs(prog: Program, plan: dict[str, str] | None):
    """shard_map in_specs pytree for the params dict: pre-split weights
    for planned FFNs, replicated everything else."""
    from gala_tpu.lowering.interp import param_specs

    out = {}
    for kind, name, _dims, _layer in param_specs(prog):
        sp = plan.get(name) if plan else None
        if kind == "linear" and sp == "col":
            out[name] = {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}
        elif kind == "linear" and sp == "row":
            out[name] = {"w": P(MODEL_AXIS, None), "b": P()}
        else:
            out[name] = P()        # prefix spec: replicated subtree
    return out
