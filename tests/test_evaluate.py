"""Evaluation-harness job tests (scripts/evaluate.py).

Runs the figure/table jobs in-process at tiny scale and checks the
reference CSV schemas (reference: scripts/Evaluations/*.py headers).
"""
import argparse
import importlib.util
import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

_SPEC = importlib.util.spec_from_file_location(
    "evaluate", os.path.join(os.path.dirname(__file__), "..", "scripts", "evaluate.py")
)
evaluate = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(evaluate)


def _args(tmp_path, **kw):
    base = dict(
        iters=6, scale=0.02, datasets=["Cora"], models=["gcn"],
        fractions=[0.01], layers=[2], hidden=[8],
        outdir=str(tmp_path),
        t6_dataset="Cora", jnp_dtype=None, data_root=None,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def _rows(tmp_path, name, header):
    path = os.path.join(str(tmp_path), name)
    lines = open(path).read().strip().splitlines()
    assert lines[0] == header
    return [ln.split(",") for ln in lines[1:]]


def test_table5_schema(tmp_path):
    evaluate.job_table5(_args(tmp_path))
    rows = _rows(tmp_path, "stat_table5.csv",
                 "dataset,opts,inference_time,total_time")
    assert [r[1] for r in rows] == ["none", "cir", "dir", "all"]
    for r in rows:
        assert np.isfinite(float(r[2])) and np.isfinite(float(r[3]))


def test_fig18_schema(tmp_path):
    evaluate.job_fig18(_args(tmp_path, layers=[2], hidden=[8, 16]))
    rows = _rows(tmp_path, "stat_fig18.csv",
                 "dataset,layers,hidden,inference_time,total_time")
    assert [(r[1], r[2]) for r in rows] == [("2", "8"), ("2", "16")]


def test_table7_schema(tmp_path):
    evaluate.job_table7(_args(tmp_path))
    rows = _rows(tmp_path, "stat_table7.csv",
                 "dataset,sampling,inference_time,accuracy,data")
    assert [r[1] for r in rows] == ["none", "data", "kernel", "dynamic"]
    assert all(r[4] == "synthetic" for r in rows)  # provenance marker


def test_table6_schema(tmp_path):
    evaluate.job_table6(_args(tmp_path, fractions=[0.5, 1.0], scale=0.04))
    rows = _rows(tmp_path, "stat_table6.csv",
                 "dataset,fraction,inference_time,total_time,memory_mb")
    assert [r[0] for r in rows] == ["Cora", "Cora"]
    assert all(float(r[4]) > 0 for r in rows)  # memory_mb populated
