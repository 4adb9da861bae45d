"""Card-only tests: the aggregation executors on an NVIDIA GPU at Arxiv-1.0
widths (169,343 nodes, 128 features, hidden 32, 40 classes) against the
plain references in tests/plain_reference.py, forward and backward.
The references run in float64 (jax.enable_x64), so a comparison sees only
the executor's own float32 rounding: an f32 reference summing a hub's
thousands of in-edges in scatter order carries about as much error as
the tolerance allows.  Each comparison records its worst
|got - want| / (atol + rtol * |want|) as a junit property, which
chip_smoke.py prints.

Run with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`
(chip_smoke.py does).  Without a GPU every test skips.

Tolerances:
- f32 under jax.default_matmul_precision("highest"): rtol 1e-4 — only the
  order of summation differs; atol 1e-4 for sums that cancel to ~0;
- f32 at default precision, where the GPU may run f32 dots in TF32 (about
  three decimal digits): rtol 1e-2, atol 1e-2;
- bf16 activations: final training loss within 5% of the f32 run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import plain_reference as ref

pytestmark = pytest.mark.gpu

TOL = {"highest": 1e-4, "default": 1e-2}


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="module")
def arxiv(gpu):
    from gala_tpu.data.datasets import load_dataset

    g_host, *_ = load_dataset("Arxiv", scale=1.0)
    e = (jnp.asarray(g_host.src.astype(np.int32)),
         jnp.asarray(g_host.dst.astype(np.int32)),
         jnp.asarray(g_host.vals.astype(np.float32)))
    return g_host, e


@pytest.fixture(scope="module")
def bell_graph(arxiv):
    from gala_tpu.ops.graph import Graph

    g = Graph.from_host(arxiv[0], strategy="bell")
    assert g.bell is not None
    return g


@pytest.fixture(scope="module")
def attn_graph(arxiv):
    from gala_tpu.ops.graph import Graph

    g = Graph.from_host(arxiv[0], strategy="bell", attention=True)
    assert g.attn is not None
    return g


def _rand(shape, seed, rows=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if rows is not None:
        a[rows:] = 0.0  # padding rows stay inert
    return jnp.asarray(a)


def _close(pairs, precision, record):
    """assert_allclose(got, want, rtol=tol, atol=tol) for each
    (name, got, want), after recording every pair's worst ratio."""
    tol = TOL[precision]
    pairs = [(name, np.asarray(got, np.float64), np.asarray(want, np.float64))
             for name, got, want in pairs]
    for name, got, want in pairs:
        ratio = np.max(np.abs(got - want) / (tol + tol * np.abs(want)))
        record(f"err_over_tol_{name}", f"{ratio:.3g}")
    for name, got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def _out_and_grads(f, ct, *args):
    """f(*args) and the gradients of <f(*args), ct>, in one executable."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(ct)

    return jax.jit(run)(*args)


def _reference(f, ct, *args):
    """_out_and_grads of a plain reference, evaluated in float64."""
    with jax.enable_x64(True):
        return _out_and_grads(
            f, *(jnp.asarray(a, jnp.float64) for a in (ct,) + args))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("width", [128, 40])
def test_bell_spmm_matches_reference(arxiv, bell_graph, width, precision,
                                     record_property):
    from gala_tpu.ops.spmm import spmm

    g_host, (src, dst, vals) = arxiv
    g = bell_graph
    n = g_host.n_rows
    x = _rand((g.c_pad, width), 0, rows=n)
    ct = _rand((n, width), 1)
    with jax.default_matmul_precision(precision):
        out, (dx,) = _out_and_grads(lambda x_: spmm(g, x_)[:n], ct, x)
    want, (dx_ref,) = _reference(
        lambda x_: ref.spmm(src, dst, vals, x_, n), ct, x)
    _close([("out", out, want), ("dx", dx[:n], dx_ref[:n])], precision,
           record_property)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("width", [32, 40])
def test_fused_attention_matches_reference(arxiv, attn_graph, width, precision,
                                           record_property):
    from gala_tpu.ops.attention import attention_aggregate

    g_host, (src, dst, _) = arxiv
    g = attn_graph
    n = g_host.n_rows
    x = _rand((g.c_pad, width), 2, rows=n)
    vl = _rand((g.c_pad, 1), 3, rows=n)
    vr = _rand((g.n_pad, 1), 4, rows=n)
    ct = _rand((n, width), 5)

    def fused(x_, vl_, vr_):
        return attention_aggregate(
            g.n_pad, g.c_pad, ref.SLOPE, g.attn, x_, vl_, vr_)[:n]

    def plain(x_, vl_, vr_):
        return ref.edge_softmax_aggregate(src, dst, x_, vl_, vr_, n)

    with jax.default_matmul_precision(precision):
        out, grads = _out_and_grads(fused, ct, x, vl, vr)
    want, grads_ref = _reference(plain, ct, x, vl, vr)
    _close([("out", out, want)]
           + [(name, got[:n], exp[:n]) for name, got, exp
              in zip(("dx", "dvl", "dvr"), grads, grads_ref)],
           precision, record_property)


def test_bf16_training_tracks_f32(gpu):
    """GCN on Arxiv-1.0 through the public API: bf16 activations end
    within 5% of the f32 run's training loss after 30 epochs.  The
    epoch schedule is chip_smoke.py's, so its GCN runs find these
    executables in the persistent compile cache."""
    import gala_tpu
    from __graft_entry__ import GCN_DSL

    final = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        cm = gala_tpu.compile_source(GCN_DSL, mode="train", scale=1.0,
                                     dtype=dtype)
        res = cm.train(iters=30, warmup=5)
        assert np.all(np.isfinite(res.losses))
        final[dtype] = res.losses[-1]
    rel = abs(final[jnp.bfloat16] - final[jnp.float32]) / final[jnp.float32]
    assert rel <= 0.05, final
