"""DIR `col_tile` schedule axis: the directive must change the EXECUTED
chunk granularity (reference ordered column tiling:
src/ops/tiling.h:222-284 + src/codegen/cuda.h:470-497), not just parse
into the IR — and tiled execution must stay numerically identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gala_tpu.data.csr import densify
from gala_tpu.ops.graph import Graph
from gala_tpu.ops.spmm import _seg_oneshot, _seg_scan, spmm


def _x(g, f=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(g.n_nodes, f)).astype(np.float32)
    return x, g.pad_nodes(x)


def test_seg_scan_chunks_nondivisible():
    """A chunk size that does not divide the edge count must still chunk
    (zero-padded), never silently fall back to one shot."""
    rng = np.random.default_rng(3)
    e, n, f = 1000, 64, 8
    src = jnp.asarray(rng.integers(0, n, e), jnp.int32)
    dst = jnp.sort(jnp.asarray(rng.integers(0, n, e), jnp.int32))
    vals = jnp.asarray(rng.normal(size=e), jnp.float32)
    x = jnp.asarray(rng.normal(size=(n, f)), jnp.float32)
    ref = _seg_oneshot(src, dst, vals, x, n)
    for chunk in (77, 333, 5000):   # none divide 1000; 5000 > e
        out = _seg_scan(src, dst, vals, x, n, chunk)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", ["segment_scan", "bell"])
def test_col_tile_reaches_graph(small_dataset, strategy):
    g_host, *_ = small_dataset
    g = Graph.from_host(g_host, strategy=strategy, col_tile=40)
    if strategy == "segment_scan":
        assert g.scan_chunk > 0
    else:
        assert g.bell.chunk_slots > 0
        assert g.t_bell.chunk_slots > 0


@pytest.mark.parametrize("strategy", ["segment_scan", "bell"])
def test_col_tile_spmm_parity(small_dataset, strategy):
    """Tiled execution == dense reference, forward and backward."""
    g_host, *_ = small_dataset
    g = Graph.from_host(g_host, strategy=strategy, col_tile=40)
    a = densify(g_host)
    x, xp = _x(g)
    out = np.asarray(spmm(g, xp))
    np.testing.assert_allclose(out[: g.n_nodes], a @ x, rtol=1e-4, atol=1e-4)
    grad = jax.grad(lambda v: jnp.sum(spmm(g, v) ** 2))(xp)
    np.testing.assert_allclose(
        np.asarray(grad)[: g.n_nodes], 2 * a.T @ (a @ x), rtol=1e-3, atol=1e-3
    )


@pytest.mark.slow
def test_col_tile_attention_parity(small_dataset, monkeypatch):
    """col_tile forces the chunked attention path; results must match
    the flat path bit-for-bit-ish (the flat path is restored as the
    oracle via _ATTN_FLAT_ELEMS — default is chunked everywhere)."""
    import gala_tpu.ops.attention as A
    from gala_tpu.ops.attention import _is_flat, attention_aggregate

    monkeypatch.setattr(A, "_ATTN_FLAT_ELEMS", 1 << 29)  # g0 = flat oracle
    g_host, *_ = small_dataset
    g0 = Graph.from_host(g_host, strategy="bell", attention=True)
    g1 = Graph.from_host(g_host, strategy="bell", attention=True, col_tile=50)
    assert _is_flat(g0.attn, 16, 1) and not _is_flat(g1.attn, 16, 1)

    rng = np.random.default_rng(5)
    x = g0.pad_nodes(rng.normal(size=(g0.n_nodes, 16)).astype(np.float32))
    vl = g0.pad_nodes(rng.normal(size=(g0.n_nodes, 1)).astype(np.float32))
    vr = g0.pad_nodes(rng.normal(size=(g0.n_nodes, 1)).astype(np.float32))

    def run(g, x, vl, vr):
        return attention_aggregate(g.n_pad, g.c_pad, 0.2, g.attn, x, vl, vr)

    o0 = np.asarray(run(g0, x, vl, vr))
    o1 = np.asarray(run(g1, x, vl, vr))
    np.testing.assert_allclose(o1, o0, rtol=1e-4, atol=1e-5)

    def loss(g):
        def f(args):
            return jnp.sum(run(g, *args) ** 2)
        return f

    d0 = jax.grad(loss(g0))((x, vl, vr))
    d1 = jax.grad(loss(g1))((x, vl, vr))
    for a0, a1 in zip(d0, d1):
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("strategy", ["segment_scan", "bell"])
def test_dsl_col_tile_reaches_executor(small_dataset, strategy, monkeypatch):
    """Golden-path test: the DSL directive flows parser -> spec -> IR
    transform edge -> lower -> executed Graph chunking.  Forced past
    the memory gate (the toy graph is far below budget, where the
    gate would drop the directive — tested separately below)."""
    from gala_tpu.dsl.parser import parse_source
    from gala_tpu.ir.build import generate_ir
    from gala_tpu.ir.data_ir import DataOpt
    from gala_tpu.lowering.lower import lower
    from tests.test_parser import GCN_SRC

    monkeypatch.setenv("GALA_FORCE_COL_TILE", "1")
    spec = parse_source(GCN_SRC)     # carries G=G.col_tile(37000)
    spec.graph.feat_size = 24
    spec.graph.label_size = 5
    spec.output_sizes = [16, 5]
    spec.col_tile = 40.0             # small tile so the toy graph chunks
    prog = generate_ir(spec)
    assert any(
        t.kind is DataOpt.COL_TILE
        for te in prog.transforms
        for t in te.transforms
    )
    cm = lower(spec, mode="inference", data=small_dataset, strategy=strategy)
    g = cm.full_graphs[0]
    if strategy == "segment_scan":
        assert g.scan_chunk > 0
    else:
        assert g.bell.chunk_slots > 0
    res = cm.train(iters=30, warmup=2)
    assert res.max_accuracy > 0.7


def test_col_tile_memory_gate_drops_below_budget(small_dataset):
    """Hand-written col_tile below the executor's flat-intermediate
    budget is DROPPED at lowering (chunking there only costs time); the
    ablation force flag is tested above."""
    from gala_tpu.dsl.parser import parse_source
    from gala_tpu.lowering.lower import lower
    from tests.test_parser import GCN_SRC

    spec = parse_source(GCN_SRC)
    spec.graph.feat_size = 24
    spec.graph.label_size = 5
    spec.output_sizes = [16, 5]
    spec.col_tile = 40.0
    cm = lower(spec, mode="inference", data=small_dataset, strategy="bell")
    assert cm.full_graphs[0].bell.chunk_slots == 0
