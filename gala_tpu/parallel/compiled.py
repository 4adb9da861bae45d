"""SPMD execution of DSL-compiled programs.

Runs ANY compiled GALA program (`gala_tpu.compile_file/compile_source`,
all four model families, all pass pipelines) over a device mesh: the IR
interpreter (gala_tpu.lowering.interp) is executed inside `shard_map`,
and the op layer dispatches `ShardedGraph` arguments to the collective
implementations (gala_tpu.parallel.ops) — the single-chip custom-VJP
kernels and the multi-chip collectives are the same program at the IR
level.  The reference has no distributed execution of any kind
(reference: src/codegen/common.h:22-29 Environment enum, unused).

Sharding: nodes range-partitioned over the mesh's 'data' axis (features,
labels, masks and destination rows co-located); remote source features
arrive by all_gather or halo all_to_all; parameters are
replicated, their gradients psum'd by shard_map's transpose.

    import gala_tpu
    from gala_tpu.parallel.compiled import shard_compiled
    cm = gala_tpu.compile_file("model.txt", mode="train")
    sm = shard_compiled(cm)          # all visible devices
    res = sm.train(iters=100)        # TrainResult, same protocol
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gala_tpu.parallel.graph import ShardedGraph
from gala_tpu.parallel.mesh import make_mesh
from gala_tpu.train import TrainResult, train


@dataclasses.dataclass
class SpmdCompiled:
    """A compiled model resharded over a mesh; mirrors CompiledModel's
    training surface."""

    cm: object                  # the underlying CompiledModel
    mesh: Mesh
    full_graphs: list
    train_graphs: list | None
    x: jax.Array
    labels: jax.Array
    train_mask: jax.Array
    test_mask: jax.Array
    forward: object             # shard_map-wrapped interp forward
    invariant: object

    def make_params(self, seed: int = 0):
        return self.cm.make_params(seed)

    def train(self, iters: int | None = None, seed: int = 0, **kw) -> TrainResult:
        params = self.make_params(seed)
        loop = self.cm.program.loop
        with self.mesh:
            return train(
                self.forward,
                params,
                self.full_graphs,
                self.x,
                self.labels,
                self.train_mask,
                self.test_mask,
                iters=iters if iters is not None else (loop.iters if loop else 100),
                valid_step=loop.valid_step if loop else 5,
                train_graphs=self.train_graphs,
                invariant=self.invariant,
                **kw,
            )


def shard_compiled(
    cm,
    mesh: Mesh | None = None,
    use_halo: bool = False,
    use_bell: bool = False,
    dtype=None,
    tp: bool = True,
) -> SpmdCompiled:
    """Reshard a CompiledModel over `mesh` (default: all visible devices
    on a 1-axis 'data' mesh).

    use_halo: exchange only boundary rows by all_to_all instead of
    all_gathering the full feature matrix per aggregation.
    use_bell: scatter-free per-shard binned-ELL reduce for structural
    aggregations (implies use_halo; see parallel.graph.ShardedBell).
    tp: when the mesh has a 'model' axis > 1, auto-plan Megatron
    col/row FFN weight splits from the IR (gala_tpu.parallel.tp) so the
    DSL-compiled program runs DP x TP; programs the planner cannot
    shard safely fall back to replicated parameters.
    """
    if cm.host_graph is None:
        raise ValueError("CompiledModel lacks host data; re-run lower()")
    if cm.spec.compute.sample_dynamic:
        raise NotImplementedError("dynamic sampling is single-chip only")
    mesh = mesh or make_mesh(model_axis=1)
    # graph/node arrays shard over 'data' only; 'model' shards features
    n_shards = int(mesh.shape["data"])

    from gala_tpu.ir.compute_ir import uses_edge_values, uses_fused_attention

    has_attn = uses_fused_attention(cm.program)
    has_ev = uses_edge_values(cm.program)
    bell_kw = dict(
        use_halo=use_halo, use_bell=use_bell,
        attention=use_bell and has_attn, edge_vals=use_bell and has_ev,
    )
    n_layers = cm.spec.num_layers
    sg = ShardedGraph.from_host(cm.host_graph, n_shards, **bell_kw)
    full_graphs = [sg] * n_layers
    train_graphs = None
    if cm.host_train_graphs is not None:
        train_graphs = [
            ShardedGraph.from_host(s, n_shards, **bell_kw)
            for s in cm.host_train_graphs
        ]
        # SPMD requires identical shapes per shard across graphs of one
        # jitted program; per-layer subgraphs differ in edge counts, which
        # is fine (each ShardedGraph pads itself uniformly)

    node_shard = NamedSharding(mesh, P("data"))

    def put(arr, dtype_=None):
        a = np.asarray(arr)
        if dtype_ is not None:
            a = a.astype(dtype_)
        padded = np.zeros((sg.n_pad,) + a.shape[1:], a.dtype)
        padded[: a.shape[0]] = a[: sg.n_pad]
        return jax.device_put(padded, node_shard)

    x = put(cm.host_feats, dtype)
    y = put(cm.host_labels)
    tm = put(cm.host_masks["train"].astype(bool))
    sm_mask = put(cm.host_masks["test"].astype(bool))

    # ---- TP plan: Megatron col/row FFN splits over the 'model' axis -- #
    from gala_tpu.ir.data_ir import SYM_CLASSES, SYM_FEATS
    from gala_tpu.parallel.tp import param_pspecs, plan_tp

    n_model = int(mesh.shape.get("model", 1))
    dim_env = {
        SYM_FEATS: int(np.asarray(cm.host_feats).shape[1]),
        SYM_CLASSES: cm.n_classes,
    }
    plan = plan_tp(cm.program, dim_env, n_model) if tp else None
    pspec = param_pspecs(cm.program, plan) if plan else P()
    if plan:
        # bake the plan into the graphs' static aux: interp's FFN
        # lowering reads graphs[0].tp_plan at trace time — purely
        # functional, nothing ambient to leak across traces
        items = tuple(sorted(plan.items()))
        full_graphs = [dataclasses.replace(g, tp_plan=items) for g in full_graphs]
        if train_graphs is not None:
            train_graphs = [
                dataclasses.replace(g, tp_plan=items) for g in train_graphs
            ]

    fwd = shard_map(
        cm.forward,
        mesh=mesh,
        in_specs=(pspec, P("data"), P("data")),
        out_specs=P("data"),
        check_vma=True,
    )
    inv = shard_map(
        cm.invariant,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=P("data"),
        check_vma=True,
    )

    return SpmdCompiled(
        cm=cm,
        mesh=mesh,
        full_graphs=full_graphs,
        train_graphs=train_graphs,
        x=x,
        labels=y,
        train_mask=tm,
        test_mask=sm_mask,
        forward=fwd,
        invariant=inv,
    )
