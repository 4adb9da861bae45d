"""SPMD execution of DSL-compiled programs (gala_tpu.parallel.compiled).

Runs on the 8-virtual-device CPU mesh (conftest).  The correctness
oracle is the single-device compiled model: the same program resharded
over the mesh must produce the same logits and train to the same
quality.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gala_tpu
from gala_tpu.parallel.compiled import shard_compiled
from gala_tpu.parallel.mesh import make_mesh

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

_SPEC = importlib.util.spec_from_file_location(
    "evaluate", os.path.join(os.path.dirname(__file__), "..", "scripts", "evaluate.py")
)
_ev = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_ev)


def _compile(model, **kw):
    src = _ev.make_dsl(model, "SpmdTest", hidden=16, iters=8)
    return gala_tpu.compile_source(
        src, mode="train", scale=1.0, strategy=kw.pop("strategy", "segment"), **kw
    )


def _single_logits(cm):
    carry = jax.jit(cm.invariant)(cm.full_graphs, cm.x)
    params = cm.make_params(0)
    return jax.jit(cm.forward)(params, cm.full_graphs, carry), params


@pytest.mark.parametrize("model", ["gcn", "gat", "gin", "sage"])
@pytest.mark.parametrize("use_halo", [False, True])
def test_spmd_forward_matches_single(model, use_halo):
    cm = _compile(model)
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, use_halo=use_halo)
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    n = cm.host_graph.n_rows
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )


def test_spmd_grads_match_single():
    cm = _compile("gcn")
    params = cm.make_params(0)
    sm = shard_compiled(cm)

    n = cm.host_graph.n_rows  # padded row counts differ between layouts

    def loss_single(p):
        carry = cm.invariant(cm.full_graphs, cm.x)
        out = cm.forward(p, cm.full_graphs, carry)
        return jnp.sum(out[:n].astype(jnp.float32) ** 2)

    def loss_spmd(p):
        carry = sm.invariant(sm.full_graphs, sm.x)
        out = sm.forward(p, sm.full_graphs, carry)
        return jnp.sum(out[:n].astype(jnp.float32) ** 2)

    g1 = jax.jit(jax.grad(loss_single))(params)
    with sm.mesh:
        g2 = jax.jit(jax.grad(loss_spmd))(params)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            rtol=5e-4, atol=5e-5,
        ),
        g2, g1,
    )


def test_spmd_trains_to_accuracy():
    cm = _compile("gcn")
    sm = shard_compiled(cm, use_halo=True)
    res = sm.train(iters=30)
    assert res.max_accuracy > 0.75, res.max_accuracy
    assert np.isfinite(res.total_time)


def test_spmd_with_subgraph_pass():
    # training_subgraph pass on: per-layer sharded train graphs
    cm = _compile("gcn")
    assert cm.host_train_graphs is not None
    sm = shard_compiled(cm)
    assert sm.train_graphs is not None and len(sm.train_graphs) == 2
    res = sm.train(iters=12)
    assert np.isfinite(res.total_time)


@pytest.mark.parametrize("model", ["gcn", "gat", "gin", "sage"])
def test_spmd_tp_forward_matches_single(model):
    """DP x TP on the compiled path: auto-planned Megatron col/row FFN
    splits over the 'model' axis (gala_tpu.parallel.tp) must reproduce
    the single-device logits."""
    from gala_tpu.parallel.tp import plan_tp
    from gala_tpu.ir.data_ir import SYM_CLASSES, SYM_FEATS

    cm = _compile(model)
    logits, params = _single_logits(cm)
    mesh = make_mesh(8, model_axis=2)
    sm = shard_compiled(cm, mesh=mesh, use_halo=(model == "gat"))
    dim_env = {SYM_FEATS: int(np.asarray(cm.host_feats).shape[1]),
               SYM_CLASSES: cm.n_classes}
    assert plan_tp(cm.program, dim_env, 2), f"{model}: TP plan expected"
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    n = cm.host_graph.n_rows
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )


def test_spmd_tp_trains_to_accuracy():
    cm = _compile("gcn")
    sm = shard_compiled(cm, mesh=make_mesh(8, model_axis=2), use_halo=True)
    res = sm.train(iters=30)
    assert res.max_accuracy > 0.75, res.max_accuracy


def test_spmd_unfused_chain_halo():
    """attention_fusion off: the SDDVV/softmax/SpMM-ev chain under SPMD,
    with the learned-edge-value aggregation riding the halo exchange."""
    src = _ev.make_dsl("gat", "SpmdTest", hidden=16, iters=8)
    import gala_tpu as gt
    from gala_tpu.dsl.parser import parse_source

    spec = parse_source(src)
    spec.passes.attention_fusion = False
    from gala_tpu.lowering.lower import lower

    cm = lower(spec, mode="train", scale=1.0, strategy="segment")
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, use_halo=True)
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    n = cm.host_graph.n_rows
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_spmd_bell_forward_matches_single(model):
    """use_bell: the scatter-free per-shard binned reduce (ShardedBell
    layouts through ops.spmm._spmm_bell inside shard_map) reproduces the
    single-chip logits."""
    cm = _compile(model)
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, use_bell=True)
    assert sm.full_graphs[0].bell is not None
    assert sm.full_graphs[0].t_bell is not None
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    n = cm.host_graph.n_rows
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )


def test_spmd_bell_trains_to_accuracy():
    cm = _compile("gcn")
    sm = shard_compiled(cm, use_bell=True)
    res = sm.train(iters=30)
    assert res.max_accuracy > 0.8, res.max_accuracy


def test_spmd_bell_attention_matches_single():
    """use_bell on a GAT program: the fused slot-space attention op runs
    per shard over the [local | halo] table (ShardedBell attention
    layouts through ops.attention.attention_aggregate inside shard_map)
    and reproduces the single-chip logits and gradients."""
    cm = _compile("gat")
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, use_bell=True)
    assert sm.full_graphs[0].attn_bell is not None
    n = cm.host_graph.n_rows
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )

    # gradient parity vs the segment-based halo SPMD path (the two SPMD
    # variants share per-shard reduction order, so this isolates the
    # bell layouts; vs single-chip the FFN grads differ by ~1e-3
    # relative from f32 accumulation order alone — both SPMD paths show
    # the IDENTICAL delta)
    sm_ref = shard_compiled(cm, use_halo=True)

    def loss_of(m):
        def loss(p):
            carry = m.invariant(m.full_graphs, m.x)
            lg = m.forward(p, m.full_graphs, carry)
            return jnp.sum(jnp.sin(lg[:n].astype(jnp.float32)))

        return loss

    with sm_ref.mesh:
        g0 = jax.jit(jax.grad(loss_of(sm_ref)))(params)
    with sm.mesh:
        g1 = jax.jit(jax.grad(loss_of(sm)))(params)
    for a0, a1 in zip(jax.tree_util.tree_leaves(g0),
                      jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(
            np.asarray(a1), np.asarray(a0), rtol=5e-4, atol=5e-4
        )


def test_spmd_bell_gat_trains_to_accuracy():
    cm = _compile("gat")
    sm = shard_compiled(cm, use_bell=True)
    res = sm.train(iters=30)
    assert res.max_accuracy > 0.75, res.max_accuracy


def test_spmd_bell_edge_values_sparser_gcn():
    """The sparse-rewrite product (3-input AGGREGATE_MUL_SUM with
    precomputed edge values) runs the scatter-free _spmm_ev_bell path
    under use_bell: slot values gather via edge_perm, matching the
    single-chip logits, and training converges."""
    src = _ev.make_dsl("gcn", "SpmdTest", hidden=16, iters=8).replace(
        'load_dataset("SpmdTest");',
        'load_dataset("SpmdTest");\nG = G.is_sparser(true);',
    )
    cm = gala_tpu.compile_source(src, mode="train", scale=1.0,
                                 strategy="segment")
    assert sum(
        1 for nd in cm.program.all_nodes()
        if len(nd.inputs) >= 3 and nd.op.name == "AGGREGATE_MUL_SUM"
    ), "sparse rewrite expected to produce edge-value aggregation"
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, use_bell=True)
    assert sm.full_graphs[0].bell.edge_perm is not None
    n = cm.host_graph.n_rows
    with sm.mesh:
        carry_s = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        logits_s = jax.jit(sm.forward)(params, sm.full_graphs, carry_s)
    np.testing.assert_allclose(
        np.asarray(logits_s[:n], np.float32),
        np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )
    res = sm.train(iters=30)
    assert res.max_accuracy > 0.8, res.max_accuracy


def test_spmd_bell_edge_values_unfused_gat_grads():
    """Unfused GAT (softmax chain -> spmm_ev with LEARNED edge values):
    the ev-bell path's d_evals sweep (per-slot SDDMM grads gathered back
    through slot_of_edge) matches the segment-based halo SPMD path."""
    from tests.test_parser import example_spec
    from gala_tpu.lowering.lower import lower

    spec = example_spec("gat")
    spec.dataset = "Cora"
    spec.passes.attention_fusion = False
    cm = lower(spec, mode="train", strategy="segment", scale=1.0)
    params = cm.make_params(0)
    n = cm.host_graph.n_rows
    sm_b = shard_compiled(cm, use_bell=True)
    sm_h = shard_compiled(cm, use_halo=True)
    assert sm_b.full_graphs[0].bell.edge_perm is not None

    def loss_of(m):
        def loss(p):
            lg = m.forward(p, m.full_graphs, m.invariant(m.full_graphs, m.x))
            return jnp.sum(jnp.sin(lg[:n].astype(jnp.float32)))

        return loss

    with sm_h.mesh:
        g_h = jax.jit(jax.grad(loss_of(sm_h)))(params)
    with sm_b.mesh:
        g_b = jax.jit(jax.grad(loss_of(sm_b)))(params)
    for a0, a1 in zip(jax.tree_util.tree_leaves(g_h),
                      jax.tree_util.tree_leaves(g_b)):
        np.testing.assert_allclose(
            np.asarray(a1), np.asarray(a0), rtol=5e-4, atol=5e-4
        )


def test_spmd_bell_ev_grads_scan_rolled(monkeypatch):
    """_bell_slot_grads' many-chunk scan branch (forced via tiny chunk
    budget) must produce the same learned-edge-value gradients as the
    halo path — covers the rolled d_evals SDDMM sweep the same way
    test_staged_gather covers the rolled staged forward."""
    import gala_tpu.ops.spmm as S
    from tests.test_parser import example_spec
    from gala_tpu.lowering.lower import lower

    monkeypatch.setattr(S, "_BELL_CHUNK_ELEMS", 1 << 12)
    monkeypatch.setattr(S, "_SCAN_MIN_CHUNKS", 2)
    spec = example_spec("gat")
    spec.dataset = "Cora"
    spec.passes.attention_fusion = False
    cm = lower(spec, mode="train", strategy="segment", scale=1.0)
    params = cm.make_params(0)
    n = cm.host_graph.n_rows
    sm_b = shard_compiled(cm, use_bell=True)
    sm_h = shard_compiled(cm, use_halo=True)

    def loss_of(m):
        def loss(p):
            lg = m.forward(p, m.full_graphs, m.invariant(m.full_graphs, m.x))
            return jnp.sum(jnp.sin(lg[:n].astype(jnp.float32)))

        return loss

    with sm_h.mesh:
        g_h = jax.jit(jax.grad(loss_of(sm_h)))(params)
    with sm_b.mesh:
        g_b = jax.jit(jax.grad(loss_of(sm_b)))(params)
    for a0, a1 in zip(jax.tree_util.tree_leaves(g_h),
                      jax.tree_util.tree_leaves(g_b)):
        np.testing.assert_allclose(
            np.asarray(a1), np.asarray(a0), rtol=5e-4, atol=5e-4
        )


def test_spmd_tp_composes_with_bell():
    """DP x TP (Megatron FFN splits over 'model') composes with the
    scatter-free bell aggregation over 'data'."""
    cm = _compile("gcn")
    logits, params = _single_logits(cm)
    sm = shard_compiled(cm, mesh=make_mesh(8, model_axis=2), use_bell=True)
    n = cm.host_graph.n_rows
    with sm.mesh:
        carry = jax.jit(sm.invariant)(sm.full_graphs, sm.x)
        lg = jax.jit(sm.forward)(params, sm.full_graphs, carry)
    np.testing.assert_allclose(
        np.asarray(lg[:n], np.float32), np.asarray(logits[:n], np.float32),
        rtol=2e-4, atol=2e-4,
    )
    res = sm.train(iters=20)
    assert res.max_accuracy > 0.75, res.max_accuracy
