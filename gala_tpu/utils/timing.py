"""Device timing: host clock around work that ends in block_until_ready.

JAX dispatch is asynchronous, so every timed window ends by waiting on
the outputs of everything it dispatched.  This replaces the reference's
cudaDeviceSynchronize()+omp_get_wtime() brackets (reference:
src/codegen/common.h:1494-1563, threading_utils.h:5).
"""
from __future__ import annotations

import time
from typing import Callable

import jax


def timeit(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean seconds per call: dispatch `iters` calls, wait on all."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters


class EpochTimer:
    """Timing for a window containing many dispatched epochs."""

    def __init__(self):
        self.t0 = None
        self.seconds = 0.0

    def start(self, outputs=None):
        """Wait on `outputs` (work dispatched before the window), then
        start the clock."""
        jax.block_until_ready(outputs)
        self.t0 = time.perf_counter()

    def stop(self, outputs, n: int = 1) -> float:
        """Wait on `outputs` (everything dispatched in the window) and
        return the mean seconds over `n` epochs."""
        if self.t0 is None:
            return 0.0
        jax.block_until_ready(outputs)
        self.seconds = time.perf_counter() - self.t0
        return self.seconds / max(n, 1)
