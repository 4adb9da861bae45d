"""Kernel tests: SpMM / SpMM-with-edge-values vs dense reference, all
strategies, forward + backward (the allclose-vs-dense test pyramid the
reference lacks, SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gala_tpu.data.csr import densify
from gala_tpu.ops.graph import Graph, choose_strategy
from gala_tpu.ops.spmm import spmm, spmm_direct, spmm_ev

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

STRATEGIES = ["dense", "segment", "segment_scan", "ell", "bell"]


@pytest.fixture(scope="module", params=STRATEGIES)
def graph_and_dense(request, small_dataset):
    g_host, *_ = small_dataset
    # keep_edges so every strategy can also run the edge-value ops
    g = Graph.from_host(g_host, strategy=request.param, keep_edges=True)
    return g, densify(g_host)


def _x(g, f=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(g.n_nodes, f)).astype(np.float32)
    return x, g.pad_nodes(x)


def test_spmm_forward(graph_and_dense):
    g, a = graph_and_dense
    x, xp = _x(g)
    out = np.asarray(spmm(g, xp))
    np.testing.assert_allclose(out[: g.n_nodes], a @ x, rtol=1e-4, atol=1e-4)
    # padding rows produce zeros for real sources
    assert np.allclose(out[g.n_nodes :], 0.0, atol=1e-5)


def test_spmm_backward_uses_transpose(graph_and_dense):
    g, a = graph_and_dense
    x, xp = _x(g)
    grad = jax.grad(lambda v: jnp.sum(spmm(g, v) ** 2))(xp)
    ref = 2 * a.T @ (a @ x)
    np.testing.assert_allclose(np.asarray(grad)[: g.n_nodes], ref, rtol=1e-3, atol=1e-3)


def test_spmm_ev_grads(graph_and_dense):
    g, a = graph_and_dense
    x, xp = _x(g)
    vals = g.vals

    dv = jax.grad(lambda v: jnp.sum(spmm_ev(g, v, xp) ** 2))(vals)
    dz = 2 * (a @ x)
    src = np.asarray(g.src)[: g.n_edges]
    dst = np.asarray(g.dst)[: g.n_edges]
    dv_ref = np.sum(dz[dst] * x[src], axis=-1)
    np.testing.assert_allclose(np.asarray(dv)[: g.n_edges], dv_ref, rtol=1e-3, atol=1e-3)

    dx = jax.grad(lambda v: jnp.sum(spmm_ev(g, vals, v) ** 2))(xp)
    np.testing.assert_allclose(
        np.asarray(dx)[: g.n_nodes], 2 * a.T @ (a @ x), rtol=1e-3, atol=1e-3
    )


def test_spmm_direct_detached(graph_and_dense):
    g, a = graph_and_dense
    x, xp = _x(g)
    grad = jax.grad(lambda v: jnp.sum(spmm_direct(g, v)))(xp)
    assert np.allclose(np.asarray(grad), 0.0)


def test_degrees_match(graph_and_dense):
    g, a = graph_and_dense
    np.testing.assert_allclose(
        np.asarray(g.deg)[: g.n_nodes, 0], a.sum(axis=1), rtol=1e-6
    )


def test_strategy_heuristic():
    assert choose_strategy(1000, 1000, 5000) == "dense"
    assert choose_strategy(10**6, 10**6, 10**5) == "bell"
    assert choose_strategy(10**6, 10**6, 10**9) == "bell"
    assert choose_strategy(10**5, 10**5, 10**5) == "bell"
    assert choose_strategy(10**5, 10**5, 10**6) == "bell"
    assert choose_strategy(10**6, 10**6, 10**5, edge_vals=True) == "ell"


def test_ell_layout(small_dataset):
    from gala_tpu.data.ell import build_ell, inflation

    g_host, *_ = small_dataset
    ell = build_ell(g_host)
    # every edge appears exactly once across slots
    import numpy as np

    real = ell.vals != 0
    assert int(real.sum()) == g_host.n_edges
    assert inflation(ell, g_host.n_edges) < 4.0
    # vrow sorted ascending then phantom
    v = ell.n_virtual
    assert np.all(np.diff(ell.vrow[:v]) >= 0)


def test_spmm_under_jit(graph_and_dense):
    g, a = graph_and_dense
    x, xp = _x(g)
    out = jax.jit(lambda gg, v: spmm(gg, v))(g, xp)  # Graph as pytree arg
    np.testing.assert_allclose(np.asarray(out)[: g.n_nodes], a @ x, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# binned ELL (strategy 'bell') specifics
# --------------------------------------------------------------------------- #
def _random_graph(n, e, rng, directed=True, self_loops=True, hub=None):
    from gala_tpu.data.csr import coo_to_csr, symmetrize

    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if hub is not None:
        # force one node above the hub threshold (degree > 128)
        src = np.concatenate([src, rng.integers(0, n, 300)])
        dst = np.concatenate([dst, np.full(300, hub)])
    if not directed:
        src, dst = symmetrize(src, dst, n)
    if self_loops:
        src = np.concatenate([src, np.arange(n)])
        dst = np.concatenate([dst, np.arange(n)])
    key = np.unique(src.astype(np.int64) * n + dst)
    src, dst = key // n, key % n
    vals = rng.standard_normal(len(src)).astype(np.float32)
    return coo_to_csr(src, dst, vals, n_rows=n)


@pytest.mark.parametrize("directed", [False, True])
def test_bell_hub_and_weighted(directed):
    rng = np.random.default_rng(11)
    n = 400
    g_host = _random_graph(n, 4000, rng, directed=directed, hub=7)
    g = Graph.from_host(g_host, strategy="bell")
    a = densify(g_host)
    x, xp = _x(g)
    out = np.asarray(spmm(g, xp))[:n]
    np.testing.assert_allclose(out, a @ x, rtol=2e-4, atol=2e-4)
    dx = np.asarray(jax.grad(lambda v: spmm(g, v).sum())(xp))[:n]
    np.testing.assert_allclose(dx, a.T @ np.ones((n, 16), np.float32), rtol=2e-4, atol=2e-4)


def test_bell_relabeled_identity_order(small_dataset):
    """After bell_order relabeling the layout needs no output reindex."""
    from gala_tpu.data.ell import bell_order, build_binned_ell
    from gala_tpu.data.reordering import apply_reorder

    g_host, feats, labels, masks = small_dataset
    order = bell_order(g_host)
    g2, f2, l2, m2, _ = apply_reorder(g_host, order, feats, labels, masks)
    hb = build_binned_ell(g2)
    assert hb.identity_order
    g = Graph.from_host(g2, strategy="bell")
    assert g.bell.out_index is None
    x = np.random.default_rng(1).normal(size=(g2.n_rows, 8)).astype(np.float32)
    out = np.asarray(spmm(g, g.pad_nodes(x)))[: g2.n_rows]
    np.testing.assert_allclose(out, densify(g2) @ x, rtol=2e-4, atol=2e-4)


def test_bell_diag_split(small_dataset):
    """Self-loop values are carried by the diagonal term."""
    from gala_tpu.data.ell import build_binned_ell

    g_host, *_ = small_dataset
    hb = build_binned_ell(g_host)
    if hb.diag is not None:
        assert hb.diag.shape == (g_host.n_rows,)
        # slot count excludes the split-out self loops
        n_self = int((g_host.src == g_host.dst).sum())
        assert hb.flat_cols.shape[0] >= g_host.n_edges - n_self


def test_packed_gather_table_matches(monkeypatch):
    """Forcing node-packed gather tables (tiny _PACK_MIN_BYTES) must be
    numerically identical to the unpacked path, fwd and grad, for
    several feature widths (incl. f not dividing 128)."""
    import jax
    import jax.numpy as jnp

    import gala_tpu.ops.spmm as S
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.ops.graph import Graph

    rng = np.random.default_rng(11)
    n, e = 700, 9000
    src = rng.integers(0, n, e)
    dst = np.concatenate([rng.integers(0, n, e - 400), np.full(400, 9)])
    g_host = coo_to_csr(src, dst, rng.random(e).astype(np.float32), n, n)
    g = Graph.from_host(g_host, strategy="bell")

    for f in (8, 32, 33, 64):
        x = jnp.asarray(rng.standard_normal((g.c_pad, f)).astype(np.float32))
        dout = jnp.asarray(rng.standard_normal((g.n_pad, f)).astype(np.float32))

        def loss(x):
            o = S.spmm(g, x)
            return jnp.sum(o * dout), o

        (l1, o1), g1 = jax.value_and_grad(loss, has_aux=True)(x)
        monkeypatch.setattr(S, "_PACK_MIN_BYTES", 0)
        assert S._pack_factor(g.c_pad, f, 4) > 1
        (l2, o2), g2 = jax.value_and_grad(loss, has_aux=True)(x)
        monkeypatch.setattr(S, "_PACK_MIN_BYTES", 96 << 20)
        np.testing.assert_allclose(np.asarray(o2), np.asarray(o1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(g2), np.asarray(g1),
                                   rtol=1e-5, atol=1e-5)


def test_packed_chunked_gather_matches(monkeypatch):
    """Packed + chunked (both forced) == plain path."""
    import jax
    import jax.numpy as jnp

    import gala_tpu.ops.spmm as S
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.ops.graph import Graph

    rng = np.random.default_rng(12)
    n, e = 600, 8000
    g_host = coo_to_csr(rng.integers(0, n, e), rng.integers(0, n, e),
                        rng.random(e).astype(np.float32), n, n)
    g = Graph.from_host(g_host, strategy="bell")
    x = jnp.asarray(rng.standard_normal((g.c_pad, 32)).astype(np.float32))
    ref = np.asarray(S.spmm(g, x))
    monkeypatch.setattr(S, "_PACK_MIN_BYTES", 0)
    monkeypatch.setattr(S, "_BELL_FLAT_ELEMS", 0)
    monkeypatch.setattr(S, "_BELL_CHUNK_ELEMS", 1 << 14)
    got = np.asarray(S.spmm(g, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_scan_chunked_bell_matches(monkeypatch):
    """Rolled lax.scan chunking (forced via _SCAN_MIN_CHUNKS) == the
    unrolled barrier chain == the one-shot path, fwd + bwd."""
    import jax
    import jax.numpy as jnp

    import gala_tpu.ops.spmm as S
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.ops.graph import Graph

    rng = np.random.default_rng(21)
    n, e = 600, 8000
    g_host = coo_to_csr(rng.integers(0, n, e), rng.integers(0, n, e),
                        rng.random(e).astype(np.float32), n, n)
    g = Graph.from_host(g_host, strategy="bell")
    x = jnp.asarray(rng.standard_normal((g.c_pad, 32)).astype(np.float32))
    ref = np.asarray(S.spmm(g, x))
    ref_grad = np.asarray(jax.grad(lambda v: jnp.sum(S.spmm(g, v) ** 2))(x))
    monkeypatch.setattr(S, "_BELL_FLAT_ELEMS", 0)
    monkeypatch.setattr(S, "_BELL_CHUNK_ELEMS", 1 << 14)
    monkeypatch.setattr(S, "_SCAN_MIN_CHUNKS", 2)
    got = np.asarray(S.spmm(g, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    got_grad = np.asarray(jax.grad(lambda v: jnp.sum(S.spmm(g, v) ** 2))(x))
    np.testing.assert_allclose(got_grad, ref_grad, rtol=1e-4, atol=1e-4)


def test_ell_grads_degree_asymmetric():
    """ELL forward/transpose layouts inflate to DIFFERENT virtual-row
    counts when in/out degree distributions differ (e.g. Products) —
    the custom-VJP zero cotangents must use forward-side shapes
    (regression: bwd returned transpose-shaped zeros and failed
    'bwd rule must produce an output with the same type')."""
    import jax
    import jax.numpy as jnp

    import gala_tpu.ops.spmm as S
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.ops.graph import Graph

    rng = np.random.default_rng(29)
    n, e = 400, 6000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, 30, e)  # skewed in-degrees: hubs on one side
    g_host = coo_to_csr(src, dst, rng.random(e).astype(np.float32), n, n)
    g = Graph.from_host(g_host, strategy="ell", edge_vals=True)
    assert g.ell_cols.shape[0] != g.t_ell_cols.shape[0], (
        "fixture must exercise asymmetric inflation"
    )
    x = jnp.asarray(rng.standard_normal((g.c_pad, 16)).astype(np.float32))
    ev = jnp.asarray(rng.random(g.e_pad).astype(np.float32))
    gx, ge = jax.grad(
        lambda x, ev: jnp.sum(S.spmm_ev(g, ev, x) ** 2), argnums=(0, 1)
    )(x, ev)
    assert np.all(np.isfinite(np.asarray(gx)))
    assert np.all(np.isfinite(np.asarray(ge)))
    gx2 = jax.grad(lambda x: jnp.sum(S.spmm(g, x) ** 2))(x)
    assert np.all(np.isfinite(np.asarray(gx2)))


def test_scan_chunked_ell_matches(monkeypatch):
    """Memory-bounded ELL aggregation (weighted / sparse-rewrite path):
    forcing the rolled scan via a tiny gathered-buffer budget must match
    the one-shot path, fwd + grads (incl. the edge-value grad)."""
    import jax
    import jax.numpy as jnp

    import gala_tpu.ops.spmm as S
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.ops.graph import Graph

    rng = np.random.default_rng(23)
    n, e = 500, 7000
    g_host = coo_to_csr(rng.integers(0, n, e), rng.integers(0, n, e),
                        rng.random(e).astype(np.float32), n, n)
    g = Graph.from_host(g_host, strategy="ell", edge_vals=True)
    x = jnp.asarray(rng.standard_normal((g.c_pad, 32)).astype(np.float32))
    ev = jnp.asarray(rng.random(g.e_pad).astype(np.float32))

    def loss(x, ev):
        return jnp.sum(S.spmm_ev(g, ev, x) ** 2)

    ref = np.asarray(S.spmm_ev(g, ev, x))
    ref_gx, ref_ge = jax.grad(loss, argnums=(0, 1))(x, ev)
    monkeypatch.setattr(S, "_BELL_CHUNK_ELEMS", 1 << 14)
    got = np.asarray(S.spmm_ev(g, ev, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    got_gx, got_ge = jax.grad(loss, argnums=(0, 1))(x, ev)
    np.testing.assert_allclose(np.asarray(got_gx), np.asarray(ref_gx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_ge), np.asarray(ref_ge),
                               rtol=1e-4, atol=1e-4)


def test_long_indices_path(small_dataset):
    """use_long widens edge ids/offsets (t_perm, CSR row_ptr, ELL perms)
    to int64 — the inference_long driver's >2^31-edge contract — without
    changing results.  Runs in a subprocess with JAX_ENABLE_X64=1 (the
    driver enables x64 the same way; int64 arrays canonicalize to int32
    otherwise)."""
    import os
    import subprocess
    import sys

    script = r'''
import jax, numpy as np, jax.numpy as jnp
jax.config.update("jax_platform_name", "cpu")
jax.config.update("jax_enable_x64", True)
from gala_tpu.data.synthetic import synthetic_dataset
from gala_tpu.ops.graph import Graph
from gala_tpu.ops.spmm import spmm, spmm_ev
g_host, *_ = synthetic_dataset(n=300, avg_degree=8, n_feats=24, n_classes=5, seed=7)
g32 = Graph.from_host(g_host, strategy="ell", keep_edges=True)
g64 = Graph.from_host(g_host, strategy="ell", keep_edges=True, long_indices=True)
assert g64.t_perm.dtype == jnp.int64, g64.t_perm.dtype
assert g64.row_ptr.dtype == jnp.int64
assert g64.ell_perm.dtype == jnp.int64
x = np.random.default_rng(1).normal(size=(g32.n_nodes, 8)).astype(np.float32)
xp = g32.pad_nodes(x)
np.testing.assert_allclose(np.asarray(spmm(g64, xp)), np.asarray(spmm(g32, xp)), rtol=1e-5, atol=1e-6)
vals = g32.vals
dv64 = jax.grad(lambda v: jnp.sum(spmm_ev(g64, v, xp) ** 2))(vals)
dv32 = jax.grad(lambda v: jnp.sum(spmm_ev(g32, v, xp) ** 2))(vals)
np.testing.assert_allclose(np.asarray(dv64), np.asarray(dv32), rtol=1e-4, atol=1e-5)
print("LONG-OK")
'''
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               JAX_PLATFORM_NAME="cpu")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert "LONG-OK" in r.stdout, r.stdout + r.stderr
