"""Execution-level corpus parity: every shipped DSL program (examples/)
compiles AND trains end-to-end (tiny synthetic stand-ins, CPU).

Parse-level and pass-level coverage of the same programs lives in
tests/test_parser.py; this runs the full pipeline — parser, IR, passes,
lowering, training loop — on each of them.
"""
import os

import numpy as np
import pytest

import gala_tpu

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

CORPUS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")

REPRESENTATIVES = ["gcn.txt", "gat.txt", "gin.txt", "sage.txt"]


@pytest.mark.parametrize("rel", REPRESENTATIVES)
def test_corpus_program_trains(rel):
    path = os.path.join(CORPUS, rel)
    src = open(path).read()
    cm = gala_tpu.compile_source(src, mode="train", scale=0.01)
    res = cm.train(iters=6)
    assert np.isfinite(res.total_time), rel
    assert np.isfinite(res.losses[-1]), rel
    line = res.csv(cm.spec.print_accuracy, cm.spec.print_memory)
    assert all(np.isfinite(float(p)) for p in line.split(",")), line
