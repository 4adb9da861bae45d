"""Multi-process validation: 2 jax.distributed processes, one
global mesh, one sharded training run.

The reference has no distributed execution of any kind (SURVEY.md §2.4;
its Environment enum is aspirational).  BASELINE.md names multi-host
scaling as a new capability, so the multi-host entry point gets a real test:
two OS processes (2 virtual CPU devices each) join through
parallel.multihost.initialize, build the global 4-device mesh, and run
the standard sharded GCN step.  Asserts: the cluster actually formed
(process_count == 2 in both), training converges, and the replicated
loss is IDENTICAL across processes — the psum/all_gather collectives
crossed the process boundary.

On real hardware the same worker runs unchanged per GPU host, given
the coordinator address; this test is the harness-level proof.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # two fresh jax processes: ~40s

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_training(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(r), str(port), str(outs[r])],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker hung (coordinator never formed?)")
        logs.append(out)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"

    res = [json.loads(o.read_text()) for o in outs]
    assert [r["n_proc"] for r in res] == [2, 2]
    l0, l1 = res[0]["losses"], res[1]["losses"]
    # replicated loss identical on both processes: collectives spanned DCN
    assert l0 == pytest.approx(l1, rel=0, abs=0.0)
    # and the run actually trained
    assert l0[-1] < l0[0] * 0.7, l0
