"""Multi-host initialization.

Single-host multi-GPU needs nothing: `jax.devices()` sees all local
cards and `make_mesh()` spans them (NVLink within a host).  Across
hosts, JAX's distributed runtime must be initialized once per process
before any device op; the global mesh then spans every host's cards and
the same `shard_map` programs run unchanged — XLA hands the collectives
to NCCL.  (The reference is single-GPU only; its MULTI_NODE enum values
are unused — reference: src/codegen/common.h:22-29.)

Usage: one process per host (or per card), each told the coordinator:

    from gala_tpu.parallel.multihost import initialize
    initialize(coordinator_address="10.0.0.1:8476",
               num_processes=4, process_id=rank)   # before any jax op
    mesh = make_mesh()                             # spans every card
"""
from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Initialize jax.distributed (idempotent); returns process count.

    With no arguments JAX tries to discover a cluster from its
    environment.  Safe to call in single-process runs: failures to
    discover a cluster leave the process standalone.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # already initialized, or no cluster to join (single process)
        pass
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that should write checkpoints/CSVs."""
    return jax.process_index() == 0
