"""Driver CLI smoke tests (the five reference executables as subcommands)."""
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GCN = """
G = load_dataset("TinyCli");
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    deg = G.graphs.degrees();
    norm = dsl.fn.pow(deg, -0.5);
    res = norm * G.node.feats;
    res = aggregate_fn(G.graphs, res);
    res = dsl.nn.ffn(res, out=hs);
    res = norm * res;
    G.node.feats = nonln_fn(res);
}
M1 = model(G, non_ln) {
    l1 = L1(G, 8, non_ln, aggrFn);
    l2 = L1(l1, G.labels.size(), null, aggrFn);
}
m1 = M1(G, dsl.non_ln.ReLU);
m1.train(iters=8, validation_step=4);
res = m1.eval();
"""


@pytest.mark.parametrize(
    "driver,n_fields",
    [
        ("train", 2),
        ("inference", 2),
        ("inference_sample", 3),   # +max_acc
        ("train_memory", 3),       # memMB first
    ],
)
def test_cli_csv_contract(driver, n_fields, tmp_path):
    dsl = tmp_path / "model.txt"
    dsl.write_text(GCN)
    out = subprocess.run(
        [sys.executable, "-m", "gala_tpu", driver, str(dsl),
         "--iters", "8", "--scale", "1.0"],
        capture_output=True, text=True, timeout=560,
        env={"JAX_PLATFORMS": "cpu",
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
             "HOME": str(tmp_path),
             "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache")},
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    parts = line.split(",")
    assert len(parts) == n_fields, line
    assert all(np.isfinite(float(p)) for p in parts), line

@pytest.mark.parametrize("example", ["gcn", "gat", "gin", "sage"])
def test_examples_compile_and_train(example):
    """The shipped examples/ programs run end-to-end."""
    import gala_tpu

    path = os.path.join(REPO, "examples", f"{example}.txt")
    cm = gala_tpu.compile_source(open(path).read(), mode="train", scale=0.01)
    res = cm.train(iters=6)
    assert np.isfinite(res.total_time)
