"""Fused slot-space attention (gala_tpu.ops.attention) vs dense reference
and the unfused edge-centric lowering; attention_fusion pass golden IR."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gala_tpu.data.csr import coo_to_csr, densify
from gala_tpu.ops.attention import attention_aggregate
from gala_tpu.ops.graph import Graph
from tests.test_parser import example_spec

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

SLOPE = 0.2


@pytest.fixture(scope="module")
def attn_graph():
    rng = np.random.default_rng(5)
    n, e = 400, 5000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    # hub node (degree > 128 -> exercises the segmented-softmax path)
    src = np.concatenate([src, rng.integers(0, n, 300), np.arange(n)])
    dst = np.concatenate([dst, np.full(300, 3), np.arange(n)])
    key = np.unique(src.astype(np.int64) * n + dst)
    src, dst = key // n, key % n
    g_host = coo_to_csr(src, dst, None, n_rows=n)
    return g_host, Graph.from_host(g_host, strategy="bell", attention=True, keep_edges=True)


def _dense_attn(a, x, vl, vr, n):
    z = vl[:n, 0][None, :] + vr[:n]
    z = jnp.where(z > 0, z, SLOPE * z)
    z = jnp.where(a > 0, z, -1e30)
    p = jax.nn.softmax(z, axis=1) * (a > 0)
    p = p / jnp.maximum(p.sum(1, keepdims=True), 1e-30)
    return p @ x[:n]


def test_fused_attention_forward_and_grads(attn_graph):
    g_host, g = attn_graph
    n = g_host.n_rows
    a = jnp.asarray(densify(g_host))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.c_pad, 16)).astype(np.float32))
    vl = jnp.asarray(rng.standard_normal((g.c_pad, 1)).astype(np.float32))
    vr = jnp.asarray(rng.standard_normal((g.n_pad, 1)).astype(np.float32))

    out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
    ref = _dense_attn(a, x, vl, vr, n)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref), rtol=1e-4, atol=1e-4)

    def fused_loss(x_, vl_, vr_):
        o = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x_, vl_, vr_)
        return jnp.sum(jnp.sin(o[:n]))

    def dense_loss(x_, vl_, vr_):
        return jnp.sum(jnp.sin(_dense_attn(a, x_, vl_, vr_, n)))

    gf = jax.grad(fused_loss, argnums=(0, 1, 2))(x, vl, vr)
    gd = jax.grad(dense_loss, argnums=(0, 1, 2))(x, vl, vr)
    for got, ref_g in zip(gf, gd):
        np.testing.assert_allclose(
            np.asarray(got)[:n], np.asarray(ref_g)[:n], rtol=1e-4, atol=1e-4
        )


def test_attention_fusion_pass_golden():
    from gala_tpu.ir.build import generate_ir
    from gala_tpu.ir.compute_ir import ComputeOp
    from gala_tpu.passes.pipeline import run_passes

    spec = example_spec("gat")
    prog = run_passes(generate_ir(spec), spec, mode="train")
    ops = [n.op for n in prog.loop.nodes]
    assert ops.count(ComputeOp.FUSED_ATTENTION) == 2  # one per GAT layer
    assert ComputeOp.SOFTMAX not in ops
    assert ComputeOp.AGGREGATE_EDGE_SUM not in ops

    spec2 = example_spec("gat")
    spec2.passes.attention_fusion = False
    prog2 = run_passes(generate_ir(spec2), spec2, mode="train")
    ops2 = [n.op for n in prog2.loop.nodes]
    assert ComputeOp.FUSED_ATTENTION not in ops2
    assert ops2.count(ComputeOp.SOFTMAX) == 2


def test_gat_fused_vs_unfused_end_to_end(small_dataset):
    """Same DSL program, fused (bell) vs unfused (ell) lowering: identical
    forward logits and training behavior."""
    from gala_tpu.lowering.lower import lower

    data = small_dataset

    cm1 = lower(example_spec("gat"), mode="inference", data=data, strategy="bell")
    spec2 = example_spec("gat")
    spec2.passes.attention_fusion = False
    cm2 = lower(spec2, mode="inference", data=data, strategy="ell")

    p1 = cm1.make_params(seed=0)
    p2 = cm2.make_params(seed=0)
    x1 = cm1.invariant(cm1.full_graphs, cm1.x)
    x2 = cm2.invariant(cm2.full_graphs, cm2.x)
    l1 = cm1.forward(p1, cm1.full_graphs, x1)
    l2 = cm2.forward(p2, cm2.full_graphs, x2)
    n = data[0].n_rows
    # cm1 relabels nodes (bell_order); map back for comparison
    from gala_tpu.data.ell import bell_order

    order = bell_order(data[0], split_diag=False)
    np.testing.assert_allclose(
        np.asarray(l1)[:n], np.asarray(l2)[:n][order], rtol=5e-3, atol=5e-3
    )

def test_model_gat_fused_matches_edge_path(attn_graph):
    """models.gat with the fused layout == the edge-centric path, incl.
    multi-head."""
    import dataclasses

    from gala_tpu.models import gat

    g_host, g = attn_graph
    n = g_host.n_rows
    g_plain = dataclasses.replace(g, attn=None)
    rng = np.random.default_rng(2)
    x = g.pad_nodes(rng.standard_normal((n, 12)).astype(np.float32))
    for heads in (1, 2):
        params = gat.init(jax.random.key(0), 12, [8], 5, n_heads=heads)
        out_f = np.asarray(gat.forward(params, [g, g], x, n_heads=heads))
        out_p = np.asarray(gat.forward(params, [g_plain, g_plain], x, n_heads=heads))
        np.testing.assert_allclose(out_f[:n], out_p[:n], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("scan_min", [2, 1 << 30],
                         ids=["rolled-scan", "unrolled"])
def test_chunked_attention_matches_flat(attn_graph, monkeypatch, scan_min):
    """Forcing the memory-bounded chunked path (tiny _ATTN_CHUNK_ELEMS)
    must reproduce the flat path's output and gradients exactly (same
    math, different blocking).  Parametrized over _SCAN_MIN_CHUNKS so
    both the rolled lax.scan form and the unrolled barrier chain are
    pinned (bins and hubs, forward and both backward passes)."""
    import gala_tpu.ops.attention as A

    monkeypatch.setattr(A, "_SCAN_MIN_CHUNKS", scan_min)
    g_host, g = attn_graph
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((g.c_pad, 16)).astype(np.float32))
    vl = jnp.asarray(rng.standard_normal((g.c_pad, 1)).astype(np.float32))
    vr = jnp.asarray(rng.standard_normal((g.n_pad, 1)).astype(np.float32))
    dout = jnp.asarray(rng.standard_normal((g.n_pad, 16)).astype(np.float32))

    def loss(x, vl, vr):
        out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        return jnp.sum(out * dout), out

    monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 1 << 29)  # flat oracle
    assert A._is_flat(g.attn, 16, 1)
    (l1, out1), g1 = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, vl, vr)

    monkeypatch.setattr(A, "_ATTN_CHUNK_ELEMS", 4096)
    monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 4096)
    assert not A._is_flat(g.attn, 16, 1)
    (l2, out2), g2 = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, vl, vr)

    np.testing.assert_allclose(np.asarray(out2), np.asarray(out1), rtol=2e-5, atol=2e-5)
    for a1, a2 in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=2e-4, atol=2e-5)

    # PRIMAL (inference: no grad, need_flash=False skips the pos-stat
    # accumulation) must equal the differentiated forward's output
    out_primal = attention_aggregate(
        g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr
    )
    np.testing.assert_allclose(
        np.asarray(out_primal), np.asarray(out1), rtol=2e-5, atol=2e-5
    )


def test_packed_chunked_attention_matches(attn_graph, monkeypatch):
    """Packed tables + chunked attention (both forced) == flat path."""
    import gala_tpu.ops.attention as A
    import gala_tpu.ops.spmm as S

    g_host, g = attn_graph
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((g.c_pad, 16)).astype(np.float32))
    vl = jnp.asarray(rng.standard_normal((g.c_pad, 1)).astype(np.float32))
    vr = jnp.asarray(rng.standard_normal((g.n_pad, 1)).astype(np.float32))
    dout = jnp.asarray(rng.standard_normal((g.n_pad, 16)).astype(np.float32))

    def loss(x, vl, vr):
        out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        return jnp.sum(out * dout), out

    monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 1 << 29)  # flat oracle
    (l1, out1), g1 = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, vl, vr)
    monkeypatch.setattr(A, "_ATTN_CHUNK_ELEMS", 8192)
    monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 8192)
    monkeypatch.setattr(S, "_PACK_MIN_BYTES", 0)
    (l2, out2), g2 = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, vl, vr)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out1), rtol=2e-5, atol=2e-5)
    for a1, a2 in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=2e-4, atol=2e-5)


def test_multihead_attention_vs_dense_reference(attn_graph, monkeypatch):
    """H=4 fused attention (one gather for all heads) vs explicit
    per-head dense softmax math, forward + grads, flat AND chunked."""
    import gala_tpu.ops.attention as A

    g_host, g = attn_graph
    n = g_host.n_rows
    a = jnp.asarray(densify(g_host))
    nh, fh = 4, 6
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((g.c_pad, nh * fh)).astype(np.float32))
    vl = jnp.asarray(rng.standard_normal((g.c_pad, nh)).astype(np.float32))
    vr = jnp.asarray(rng.standard_normal((g.n_pad, nh)).astype(np.float32))

    def dense_ref(x_, vl_, vr_):
        outs = []
        for h in range(nh):
            outs.append(
                _dense_attn(a, x_[:, h * fh : (h + 1) * fh],
                            vl_[:, h : h + 1], vr_[:, h : h + 1], n)
            )
        return jnp.concatenate(outs, axis=1)

    for chunked in (False, True):
        if chunked:
            monkeypatch.setattr(A, "_ATTN_CHUNK_ELEMS", 4096)
            monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 4096)
        else:
            monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 1 << 29)  # flat arm
        out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        ref = dense_ref(x, vl, vr)
        np.testing.assert_allclose(
            np.asarray(out)[:n], np.asarray(ref), rtol=1e-4, atol=1e-4
        )

        def f_loss(x_, vl_, vr_):
            o = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x_, vl_, vr_)
            return jnp.sum(jnp.sin(o[:n]))

        def d_loss(x_, vl_, vr_):
            return jnp.sum(jnp.sin(dense_ref(x_, vl_, vr_)[:n]))

        gf = jax.grad(f_loss, argnums=(0, 1, 2))(x, vl, vr)
        gd = jax.grad(d_loss, argnums=(0, 1, 2))(x, vl, vr)
        for got, want in zip(gf, gd):
            np.testing.assert_allclose(
                np.asarray(got)[:n], np.asarray(want)[:n], rtol=2e-4, atol=2e-4
            )


def test_hub_only_graph_attention():
    """A graph where EVERY node is a hub (deg > 128): no bin segments at
    all — the layout is one hub block, and the whole fused path (online
    softmax forward + both backward passes) runs through the hub
    branches exclusively."""
    from gala_tpu.data.csr import coo_to_csr, densify

    rng = np.random.default_rng(3)
    n = 300
    src = rng.integers(0, n, n * 400)
    dst = rng.integers(0, n, n * 400)
    key = np.unique(src.astype(np.int64) * n + dst)  # dedupe: duplicate
    src, dst = key // n, key % n                     # edges are distinct
    g_host = coo_to_csr(src, dst, None, n_rows=n)    # softmax slots
    assert np.diff(g_host.row_ptr).min() > 128

    g = Graph.from_host(g_host, strategy="bell", attention=True,
                        keep_edges=True)
    ab_p = g.attn
    assert not ab_p.fwd.bin_ks and ab_p.fwd.n_big == n

    a = jnp.asarray(densify(g_host))
    x = jnp.asarray(rng.standard_normal((g.c_pad, 16)).astype(np.float32))
    vl = jnp.asarray(rng.standard_normal((g.c_pad, 1)).astype(np.float32))
    vr = jnp.asarray(rng.standard_normal((g.n_pad, 1)).astype(np.float32))

    def loss(ab, x_, vl_, vr_):
        o = attention_aggregate(g.n_pad, g.c_pad, SLOPE, ab, x_, vl_, vr_)
        return jnp.sum(jnp.sin(o[:n])), o

    (l_d, out_p), g_p = jax.value_and_grad(
        lambda *a_: loss(ab_p, *a_), argnums=(0, 1, 2), has_aux=True
    )(x, vl, vr)
    ref = _dense_attn(a, x, vl, vr, n)
    np.testing.assert_allclose(
        np.asarray(out_p)[:n], np.asarray(ref), rtol=1e-4, atol=1e-4
    )

    def dense_loss(x_, vl_, vr_):
        return jnp.sum(jnp.sin(_dense_attn(a, x_, vl_, vr_, n)))

    g_d = jax.grad(dense_loss, argnums=(0, 1, 2))(x, vl, vr)
    for got, want in zip(g_p, g_d):
        np.testing.assert_allclose(
            np.asarray(got)[:n], np.asarray(want)[:n], rtol=1e-3, atol=1e-4
        )
