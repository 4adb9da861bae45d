"""Profiling markers — the LIKWID-wrapper analog (reference:
src/utils/profiling.h:1-81, compile-time-gated marker macros).

Here the equivalents are the XLA profiler trace (viewable in
TensorBoard / xprof / Perfetto) plus named trace annotations.
Everything is no-op-safe when profiling is unavailable, matching the
reference's no-op default when LIKWID_PERFMON is off.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """Capture an XLA profiler trace around the enclosed block.

    with profile_trace("/tmp/gala-trace"):
        train_step(...)
    """
    log_dir = log_dir or os.environ.get("GALA_TPU_TRACE_DIR", "/tmp/gala_tpu_trace")
    import jax

    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        started = False
    try:
        yield log_dir
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


@contextlib.contextmanager
def marker(name: str):
    """Named region annotation (LIKWID marker analog; shows up in traces)."""
    import jax

    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def annotate(name: str):
    """Decorator form of `marker`."""
    def deco(fn):
        def wrapped(*a, **k):
            with marker(name):
                return fn(*a, **k)

        return wrapped

    return deco