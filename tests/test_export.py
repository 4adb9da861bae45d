"""AOT export/load tests: the standalone-artifact analog of the
reference's generated ./gala_model executable (reference:
src/codegen/cuda.h writeCode; the driver re-runs the built binary
without the compiler)."""
import os

import jax
import numpy as np
import pytest

import gala_tpu
from gala_tpu.export import (
    FORMAT_VERSION,
    _chunk_plan,
    export_compiled,
    load_exported,
)

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

GCN = """
G = load_dataset("Cora");
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
    l1 = L1(G, 32, non_ln, aggrFn);
    l2 = L1(l1, G.labels.size(), null, aggrFn);
}
m1 = M1(G, dsl.non_ln.ReLU);
m1.train(iters=100, validation_step=5);
res = m1.eval();
"""


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cm = gala_tpu.compile_source(GCN, mode="train", scale=0.3)
    d = str(tmp_path_factory.mktemp("exported"))
    # cpu+cuda: the export itself pins that the training step lowers for
    # the GPU device-lessly
    export_compiled(cm, d, platforms=("cpu", "cuda"))
    return cm, d


def test_artifact_layout(artifact):
    _, d = artifact
    names = set(os.listdir(d))
    assert {"manifest.json", "state.npz", "step.jaxexport",
            "chunk.jaxexport", "fwd.jaxexport", "fwdchunk.jaxexport",
            "acc.jaxexport"} <= names


def test_forward_parity(artifact):
    cm, d = artifact
    em = load_exported(d)
    params = cm.make_params(0)
    xc = (
        jax.jit(cm.invariant)(cm.full_graphs, cm.x)
        if cm.invariant is not None
        else cm.x
    )
    lg_cm = np.asarray(cm.forward(params, cm.full_graphs, xc))
    lg_em = np.asarray(em.forward())
    np.testing.assert_allclose(lg_cm, lg_em, atol=1e-5)


def test_exported_training_reaches_accuracy(artifact):
    _, d = artifact
    em = load_exported(d)
    res = em.train(iters=40)
    assert res.max_accuracy > 0.8, res.max_accuracy
    assert np.isfinite(res.losses).all()
    # the CSV contract survives the roundtrip
    line = em.run(iters=12)
    parts = line.split(",")
    assert len(parts) == 2 and all(float(p) >= 0 for p in parts)


def test_chunk_plan_covers_epochs():
    for iters, vs, K in [(100, 5, 4), (23, 5, 4), (7, 0, 3), (12, 5, 1)]:
        plan = _chunk_plan(iters, vs, warmup=5, K=K)
        seen = []
        for kind, e, ln in plan:
            seen.extend(range(e, e + ln))
            if kind == "chunk":
                assert ln == K
                # chunks cross neither validation epochs nor warmup
                assert all(
                    not (vs > 0 and x % vs == 0) for x in range(e, e + ln)
                )
                assert e >= 5 or e + ln <= 5
        assert seen == list(range(iters))


def test_version_guard(artifact, tmp_path):
    import json
    import shutil

    _, d = artifact
    d2 = tmp_path / "newer"
    shutil.copytree(d, d2)
    m = json.load(open(d2 / "manifest.json"))
    m["version"] = FORMAT_VERSION + 1
    json.dump(m, open(d2 / "manifest.json", "w"))
    with pytest.raises(ValueError, match="newer"):
        load_exported(str(d2))


def test_cli_export_and_run(tmp_path):
    from gala_tpu.__main__ import main

    src = tmp_path / "gcn.txt"
    src.write_text(GCN)
    out = str(tmp_path / "artifact")
    main(["export", str(src), "-o", out, "--scale", "0.3",
          "--platforms", "cpu"])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["run_exported", out, "--iters", "12"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert len(line.split(",")) == 2


GAT = GCN.replace(
    'aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);',
    'aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);\n'
    'edgeFn = dsl.get_edge_aggregate(fn = dsl.fn.sum);',
).replace(
    """L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    deg = G.graphs.degrees();
    norm = dsl.fn.pow(deg, -0.5);
    res = norm * G.node.feats;
    res = aggregate_fn(G.graphs, res);
    res = dsl.nn.ffn(res, out=hs);
    res = norm * res;
    G.node.feats = nonln_fn(res);
}""",
    """L1 = layer(G, hs, nonln_fn, aggregate_fn, edge_fn) {
    res = dsl.nn.ffn(G.node.feats, out=hs);
    attnL = dsl.nn.ffn(res, out=1);
    attnR = dsl.nn.ffn(res, out=1);
    attn = edge_fn(G, attnL, attnR);
    G.edges.vals = dsl.fn.softmax(G, attn);
    res = aggregate_fn(G.graphs, res);
    G.node.feats = nonln_fn(res);
}""",
).replace("l1 = L1(G, 32, non_ln, aggrFn);", "l1 = L1(G, 32, non_ln, aggrFn, edgeFn);")\
 .replace("l2 = L1(l1, G.labels.size(), null, aggrFn);",
          "l2 = L1(l1, G.labels.size(), null, aggrFn, edgeFn);")


def test_gat_export_roundtrip(tmp_path):
    """Fused-attention custom_vjp programs survive jax.export (the
    backward pass is resolved at trace time)."""
    cm = gala_tpu.compile_source(GAT, mode="train", scale=0.3)
    d = str(tmp_path / "gat")
    export_compiled(cm, d, platforms=("cpu", "cuda"))
    em = load_exported(d)
    res = em.train(iters=25)
    assert res.max_accuracy > 0.6, res.max_accuracy
    assert np.isfinite(res.losses).all()
