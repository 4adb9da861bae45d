"""Lowering: ModelSpec -> optimized IR -> executable CompiledModel.

The JAX equivalent of the reference driver pipeline
(reference: tests/gala_train.cpp:65-151 — parse, input-aware schedule,
generate_ir, 4 passes, CUDAGenerator::writeCode): same stages, but the
"emitted program" is a jitted JAX training step instead of a gala.cu file.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np

from gala_tpu.data.csr import HostCSR
from gala_tpu.data.datasets import load_dataset
from gala_tpu.data.sampling import sample_graph_ab, sample_graph_random
from gala_tpu.data.subgraph import mask_subgraphs
from gala_tpu.dsl.spec import ModelSpec
from gala_tpu.ir.build import generate_ir
from gala_tpu.ir.compute_ir import ComputeOp, Program
from gala_tpu.ir.data_ir import SYM_CLASSES, SYM_FEATS
from gala_tpu.lowering.autoschedule import autoschedule
from gala_tpu.lowering.interp import make_forward, make_init_params
from gala_tpu.ops.graph import NODE_PAD, Graph, check_strategy
from gala_tpu.passes.pipeline import run_passes
from gala_tpu.train import TrainResult, train


@dataclasses.dataclass
class CompiledModel:
    """A compiled GNN program bound to a dataset: the analog of the
    reference's generated `./gala_model` executable."""

    spec: ModelSpec
    program: Program
    full_graphs: list
    train_graphs: list | None
    x: jax.Array
    labels: jax.Array
    train_mask: jax.Array
    test_mask: jax.Array
    init_params: object
    invariant: object
    forward: object
    n_classes: int
    forward_rows: object = None  # row-subset loss variant (see interp)
    # host-side data (post reorder/sample) for SPMD resharding
    host_graph: object = None
    host_train_graphs: object = None
    host_feats: object = None
    host_labels: object = None
    host_masks: object = None

    def make_params(self, seed: int = 0):
        dim_env = {
            SYM_FEATS: int(self.x.shape[1]),
            SYM_CLASSES: self.n_classes,
        }
        return self.init_params(jax.random.key(seed), dim_env)

    def train(self, iters: int | None = None, seed: int = 0, **kw) -> TrainResult:
        params = self.make_params(seed)
        loop = self.program.loop
        if self.spec.compute.sample_dynamic and "epoch_inputs" not in kw:
            from gala_tpu.data.sampling import dynamic_sample_params

            def epoch_inputs(epoch):
                ra, rb = dynamic_sample_params(epoch, seed)
                import jax.numpy as jnp

                return {"_ra": jnp.int32(ra), "_rb": jnp.int32(rb)}

            kw["epoch_inputs"] = epoch_inputs
        if kw.pop("select_rows", True) and self.forward_rows is not None \
                and "train_rows" not in kw:
            # training loss on train-mask rows only: the classifier FFN
            # and (N, C) logits shrink to the mask fraction (row-local
            # suffix selection, gala_tpu.lowering.interp.make_forward)
            def rows_of(mask):
                idx = np.flatnonzero(np.asarray(mask))
                if not idx.size:
                    return None
                pad = (-idx.size) % 8
                n_pad = int(mask.shape[0])
                # pad with the last padding row — Graph.from_host always
                # reserves >= 1 phantom row (n_pad = round_up(n+1)), so
                # its mask is False and duplicates stay inert
                assert not bool(np.asarray(mask)[n_pad - 1]), "no phantom row"
                idx = np.concatenate([idx, np.full(pad, n_pad - 1, idx.dtype)])
                return jax.numpy.asarray(idx.astype(np.int32))

            tr = rows_of(self.train_mask)
            if tr is not None:
                kw["train_rows"] = tr
                kw["forward_rows"] = self.forward_rows
                # validation accuracy on test rows only (same row-local
                # suffix selection; shrinks the (N, C) logits everywhere)
                kw.setdefault("test_rows", rows_of(self.test_mask))
        return train(
            self.forward,
            params,
            self.full_graphs,
            self.x,
            self.labels,
            self.train_mask,
            self.test_mask,
            iters=iters if iters is not None else loop.iters,
            valid_step=loop.valid_step or 5,
            lr=loop.lr,
            weight_decay=loop.weight_decay,
            train_graphs=self.train_graphs,
            invariant=self.invariant,
            measure_memory=self.spec.print_memory,
            **kw,
        )

    def run(self, iters: int | None = None) -> str:
        """Train and print the reference's stdout CSV line."""
        res = self.train(iters=iters)
        return res.csv(self.spec.print_accuracy, self.spec.print_memory)


def lower(
    spec: ModelSpec,
    mode: str = "train",
    data=None,
    data_root: str | None = None,
    strategy: str = "auto",
    scale: float = 1.0,
    seed: int = 0,
    dtype=None,
    use_long: bool = False,
) -> CompiledModel:
    """Compile a parsed spec into an executable model.

    data: optional (HostCSR, feats, labels, masks) tuple; otherwise the
    dataset named in the DSL is resolved via the registry.
    mode: 'train' or 'inference' — selects the reference's driver pass
    matrix (tests/gala_train.cpp vs gala_inference.cpp).
    """
    check_strategy(strategy)
    # ---- dataset ---------------------------------------------------- #
    if data is None:
        data = load_dataset(spec.dataset, data_root=data_root, scale=scale, seed=seed)
    g_host, feats, labels, masks = data
    n_classes = int(labels.max()) + 1

    # ---- input-aware schedule (reference: gala_inference.cpp:84-131) - #
    if spec.opt_input is not None:
        autoschedule(spec, g_host, feats.shape[1], n_classes)
    # the bound dataset always wins over declared sizes (the reference's
    # declared FEAT_SIZE/LABEL_SIZE must match its npy export; here the
    # loaded arrays are authoritative)
    spec.graph.feat_size = int(feats.shape[1])
    spec.graph.label_size = n_classes
    if spec.output_sizes:
        spec.output_sizes[-1] = n_classes

    # ---- IR + middle-end passes ------------------------------------- #
    prog = generate_ir(spec)
    prog = run_passes(prog, spec, mode=mode)

    # ---- data-level transformations --------------------------------- #
    # data sampling (reference: inplace_sample_graph_ab, tiling.h:454)
    if spec.graph.sample:
        g_host = sample_graph_ab(g_host, int(spec.graph.sample))
    # kernel-level static sampling lowers to the same fixed-degree edge
    # list (see gala_tpu.data.sampling docstring)
    elif spec.compute.sample:
        g_host = sample_graph_ab(g_host, int(spec.compute.sample))

    # graphs with learned per-edge values (GAT) need the slot->edge-id
    # permutation only the row-split ELL keeps — unless the attention
    # chain was fused into the slot-space op (attention_fusion pass)
    from gala_tpu.ir.compute_ir import uses_edge_values, uses_fused_attention

    edge_vals = uses_edge_values(prog)
    attention = uses_fused_attention(prog)
    nh = max(int(getattr(spec, "attention_heads", 1)), 1)
    if nh > 1:
        # multi-head rides the fused op's shared slot gather; the
        # unfused SDDVV/softmax chain is (N, 1)-shaped
        if not attention:
            raise ValueError(
                "attention_heads > 1 requires the fused attention path "
                "(enable the attention_fusion pass / use a standard GAT "
                "layer body)"
            )
        # final layer stays single-head (see ir/build ATTEN_L)
        bad = [d for d in spec.output_sizes[:-1] if d % nh]
        if bad:
            raise ValueError(
                f"attention_heads={nh} must divide every hidden GAT layer "
                f"width; offending sizes: {bad}"
            )
    # widest tensor an aggregation sweep actually gathers, POST-pass
    # (reorder moves shrinking FFNs first, so this is usually the hidden
    # width, NOT the input feature width); fused attention stages 4
    # extra score columns per head alongside it
    from gala_tpu.ir.compute_ir import aggregated_widths

    agg_w = max(
        aggregated_widths(prog, int(feats.shape[1]), n_classes)
    ) + (4 * nh if attention else 0)
    if strategy == "auto":
        from gala_tpu.ops.graph import choose_strategy

        strategy = choose_strategy(
            g_host.n_rows + NODE_PAD, g_host.n_cols + NODE_PAD,
            g_host.n_edges, edge_vals=edge_vals,
        )
    if strategy == "bell":
        # relabel nodes in degree-class order so the binned layout's
        # output order is the identity (zero-cost at run time) — the
        # reference's degree reordering applied at load
        # (reference: src/ops/reordering.h:1085)
        from gala_tpu.data.ell import bell_order
        from gala_tpu.data.reordering import apply_reorder

        # fused attention keeps self loops as slots, so its class order
        # is computed without the diagonal split; dynamic-sampling bells
        # keep them too (slot position must equal CSR position)
        order = bell_order(
            g_host,
            split_diag=not attention and not spec.compute.sample_dynamic,
        )
        g_host, feats, labels, masks, _ = apply_reorder(
            g_host, order, feats, labels, masks
        )

    # dynamic sampling on the bell strategies runs as per-epoch slot
    # reweighting (ops.spmm._spmm_dyn_bell) and never touches the raw
    # edge lists; only the non-bell fallback (_spmm_dyn) reads the CSR
    # arrays on device — so the padded-edge upload (and its O(E log E)
    # transpose lexsort, minutes at Products-0.25 scale) is skipped
    # whenever the reweighted path will serve
    keep_edges = (
        True
        if spec.compute.sample_dynamic and strategy != "bell"
        else "auto"
    )
    # DIR ordered column tiling: the schedule's col_tile directive
    # reaches the executor as the chunk granularity of the
    # scan/bell/attention paths (reference: src/ops/tiling.h:222-284 +
    # src/codegen/cuda.h:470-497).  Memory gate — same decision the
    # input-aware autoschedule makes (lowering/autoschedule.py): the
    # hand directive is honored only when it TIGHTENS memory below the
    # executor's own budget-driven chunking.  Dropped when (a) the
    # widest layer's flat slot intermediate already fits the flat
    # budget (chunking at all was a loss where this gate was first
    # tuned), or (b) the directive's implied chunk is COARSER than the
    # memory budget's pick — the budget already caps chunk liveness, so
    # a coarser hand tile buys nothing.  The budgets count 128-lane
    # padded columns (_phys_cols): inherited, not yet measured on the
    # GPU.
    # GALA_FORCE_COL_TILE=1 honors it regardless (the DIR ablation).
    # The gate result stays LOCAL (col_tile_eff): lower() never
    # mutates the caller's parsed spec.
    col_tile_eff = spec.col_tile
    if col_tile_eff and os.environ.get("GALA_FORCE_COL_TILE", "") != "1":
        from gala_tpu.ops.spmm import (
            _BELL_CHUNK_ELEMS, _BELL_FLAT_ELEMS, _phys_cols,
        )

        slots = max(g_host.n_edges, 1)
        mean_deg = max(g_host.n_edges / max(g_host.n_cols, 1), 1.0)
        tile_slots = max(int(col_tile_eff), 1) * mean_deg
        budget_slots = max(_BELL_CHUNK_ELEMS // _phys_cols(agg_w), 1)
        if (slots * _phys_cols(agg_w) <= _BELL_FLAT_ELEMS
                or tile_slots >= budget_slots):
            col_tile_eff = 0
    if use_long:
        spec.use_long = True
    full_g = Graph.from_host(
        g_host, strategy=strategy, undirected=spec.graph.undirected,
        edge_vals=edge_vals, attention=attention, keep_edges=keep_edges,
        col_tile=col_tile_eff or None, long_indices=spec.use_long,
        dynamic_sample=bool(spec.compute.sample_dynamic),
    )
    n_layers = spec.num_layers
    full_graphs = [full_g] * n_layers

    train_graphs = None
    subs = None
    if prog.uses_training_subgraphs:
        subs = mask_subgraphs(g_host, masks["train"], n_layers)
        train_graphs = [
            Graph.from_host(
                s, strategy=strategy, undirected=False,
                edge_vals=edge_vals,
                attention=attention, keep_edges=keep_edges,
                col_tile=col_tile_eff or None,
                dynamic_sample=bool(spec.compute.sample_dynamic),
            )
            for s in subs
        ]

    x = full_g.pad_nodes(feats)
    if dtype is not None:
        # mixed precision: bf16 activations halve the bytes every
        # gather moves; params/loss stay f32 (see ops/spmm._ell_raw)
        x = x.astype(dtype)
    y = full_g.pad_nodes(labels)
    tm = full_g.pad_nodes(masks["train"])
    sm = full_g.pad_nodes(masks["test"])

    invariant, forward, forward_rows = make_forward(prog)
    init_params = make_init_params(prog)

    return CompiledModel(
        spec=spec,
        program=prog,
        full_graphs=full_graphs,
        train_graphs=train_graphs,
        x=x,
        labels=y,
        train_mask=tm,
        test_mask=sm,
        init_params=init_params,
        invariant=invariant,
        forward=forward,
        forward_rows=forward_rows,
        n_classes=spec.graph.label_size if spec.graph.label_size > 0 else n_classes,
        # host-side retention (post-reorder/post-sample node labeling) so
        # the SPMD path (gala_tpu.parallel.compiled) can reshard the same
        # program over a device mesh without recompiling the spec
        host_graph=g_host,
        host_train_graphs=subs if prog.uses_training_subgraphs else None,
        host_feats=feats,
        host_labels=labels,
        host_masks=masks,
    )
