"""GALA-TPU: a GNN acceleration language and compiler in JAX.

A from-scratch re-design of the capabilities of the GALA artifact
(ADAPT-uiuc/GALA-GNN-Acceleration-LAnguage):

- The reference is an ahead-of-time DSL -> CUDA/libtorch code generator
  (reference: src/frontend, src/codegen/cuda.h).  Here the same DSL is
  parsed into a graph IR, optimized by the same four whole-program passes,
  and *lowered to a jitted JAX program* -- XLA is the code generator.
- Compute path: jax / XLA; sparse aggregation runs as a dense matmul on
  small graphs, as scatter-free binned-ELL gathers and dense per-degree
  reductions on large ones, and via sorted segment reductions otherwise.
- Scale-out: `jax.sharding` meshes with `shard_map` (see gala_tpu.parallel),
  which the reference lacks entirely (its Environment enum is aspirational,
  reference: src/codegen/common.h:22-29).

Public API (mirrors the reference driver CLIs, reference: tests/gala_train.cpp):

    import gala_tpu as gt
    prog  = gt.compile_file("model.txt")          # text DSL -> CompiledModel
    stats = prog.train()                          # runs the training loop
    print(stats.csv())                            # 'inference_time,total_time'
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins:
    nothing is configured here.  Otherwise the cache lives at the fixed
    path <checkout>/.jax_cache (the path is part of the cache key, so it
    must not move between runs).  CPU executables are host-ISA-specific
    (loading one compiled on a different machine can SIGILL), so
    CPU-pinned runs (cpu first in JAX_PLATFORMS, or JAX_PLATFORM_NAME=cpu)
    cache under a subdirectory named by a fingerprint of the host's CPU
    flags.  A GPU run that lists cpu as a fallback ("cuda,cpu") shares
    the top directory with JAX_PLATFORMS=cuda runs."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    first = _os.environ.get("JAX_PLATFORMS", "").split(",")[0]
    name = _os.environ.get("JAX_PLATFORM_NAME", "")
    if "cpu" in (first.strip().lower(), name.strip().lower()):
        path = _os.path.join(path, f"cpu-{_host_fingerprint()}")
    _jax.config.update("jax_compilation_cache_dir", path)


def _host_fingerprint() -> str:
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            sig = next((l for l in f if l.startswith("flags")), "")
    except OSError:
        sig = ""
    sig = sig or platform.processor() or platform.machine()
    return hashlib.sha1(sig.encode()).hexdigest()[:10]


_enable_compile_cache()

from gala_tpu.ops.graph import Graph
from gala_tpu.api import compile_file, compile_source, compile_model

__all__ = [
    "Graph",
    "compile_file",
    "compile_source",
    "compile_model",
    "__version__",
]
