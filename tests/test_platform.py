"""Platform plumbing on the CPU: the compile-cache location, chip_smoke.py
refusing to run without a GPU, the plain references the GPU tests use,
and the set of aggregation strategies."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import plain_reference as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(env_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, importing gala_tpu leaves JAX's
    setting alone; without it, the cache is <checkout>/.jax_cache (a
    host-fingerprint subdirectory on CPU-pinned runs)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORM_NAME")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import jax, gala_tpu; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path / "cache")
    else:
        assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")
        assert os.path.basename(got).startswith("cpu-")


def test_compile_cache_dir_shared_with_cpu_fallback():
    """A GPU run that lists cpu only as a fallback is not CPU-pinned: it
    caches in <checkout>/.jax_cache itself, as JAX_PLATFORMS=cuda does,
    so chip_smoke.py and its test child share one cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORM_NAME")}
    env["JAX_PLATFORMS"] = "cuda,cpu"
    code = "import jax, gala_tpu; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    assert got == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when JAX
    finds no GPU, and in a directory holding nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, script], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_plain_reference_matches_compiled(model, small_dataset):
    """The plain f32 references agree with the compiled GCN (bell SpMM)
    and GAT (fused attention) on logits and parameter gradients."""
    import gala_tpu
    from __graft_entry__ import GAT_DSL, GCN_DSL
    from gala_tpu.dsl.parser import parse_source

    spec = parse_source(GCN_DSL if model == "gcn" else GAT_DSL)
    # operator reordering moves an FFN, bias included, across the
    # aggregation and the degree scaling, which changes the result by
    # the bias term; the other passes are exact
    spec.passes.operator_reordering = False
    cm = gala_tpu.compile_model(spec, mode="train", data=small_dataset,
                                strategy="bell")
    layout = cm.full_graphs[0].bell if model == "gcn" else cm.full_graphs[0].attn
    assert layout is not None  # bell SpMM / fused attention engaged
    g = cm.host_graph
    n = g.n_rows
    src = jnp.asarray(g.src.astype(np.int32))
    dst = jnp.asarray(g.dst.astype(np.int32))
    vals = jnp.asarray(g.vals.astype(np.float32))
    x = jnp.asarray(np.asarray(cm.host_feats, np.float32))

    def compiled(p):
        carry = cm.invariant(cm.full_graphs, cm.x)
        return cm.forward(p, cm.full_graphs, carry)[:n]

    def reference(p):
        if model == "gcn":
            return ref.gcn_logits(p, src, dst, vals, x, n)
        return ref.gat_logits(p, src, dst, x, n)

    params = cm.make_params(0)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(
            np.asarray(compiled(params)), np.asarray(reference(params)),
            rtol=1e-4, atol=1e-5,
        )
        g_c = jax.grad(lambda p: jnp.sum(jnp.sin(compiled(p))))(params)
        g_r = jax.grad(lambda p: jnp.sum(jnp.sin(reference(p))))(params)
    for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(g_c), jax.tree_util.tree_leaves(g_r)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5,
            err_msg=jax.tree_util.keystr(path),
        )


def test_removed_strategy_rejected(small_dataset):
    """Only implemented strategies are accepted; the error names them."""
    import gala_tpu
    from __graft_entry__ import GCN_DSL

    with pytest.raises(ValueError, match="dense, bell, ell"):
        gala_tpu.compile_source(GCN_DSL, data=small_dataset,
                                strategy="pallas_bell")


def test_choose_strategy_values():
    from gala_tpu.ops.graph import choose_strategy

    got = {
        choose_strategy(n, n, e, edge_vals=ev)
        for n in (1_000, 20_000, 10**6)
        for e in (10**4, 10**6, 10**9)
        for ev in (False, True)
    }
    assert got == {"dense", "bell", "ell"}
