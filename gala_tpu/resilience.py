"""Failure recovery: restart-from-checkpoint training orchestration.

The reference runs a fixed iteration count with no recovery surface at
all (SURVEY.md §5).  Production training needs to survive
preemption, device loss, and host restarts, so this layer runs
training as a sequence of RESUMABLE SEGMENTS:

- each segment is a normal `train()` call that ends with a checkpoint
  (params + optimizer state, gala_tpu.checkpoint);
- a JSON progress file next to the checkpoint records completed epochs,
  so a FRESH PROCESS continues where the dead one stopped;
- an exception inside a segment (device loss, OOM, transport error)
  triggers restart from the last checkpoint, up to `max_restarts`.

Segmenting lives OUTSIDE `train()` on purpose: the timed epoch loop is
dispatch-fused (one lax.scan per validation interval) and a mid-loop
host-side save would both break the timing protocol and stall the
device stream.  A segment boundary is the natural checkpoint point —
the same place validation already waits.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from gala_tpu.train import TrainResult


def _progress_path(checkpoint_path: str) -> str:
    base = checkpoint_path.rstrip("/")
    return base.removesuffix(".npz") + ".progress.json"


def load_progress(checkpoint_path: str) -> int:
    try:
        with open(_progress_path(checkpoint_path)) as f:
            return int(json.load(f)["epochs_done"])
    except Exception:
        return 0


def _save_progress(checkpoint_path: str, epochs_done: int) -> None:
    with open(_progress_path(checkpoint_path), "w") as f:
        json.dump({"epochs_done": epochs_done}, f)


def _ckpt_exists(path: str) -> bool:
    return os.path.exists(path) or os.path.exists(path + ".npz")


def _resume_arg(path: str) -> str:
    return path if os.path.exists(path) else path + ".npz"


def train_with_recovery(
    train_fn: Callable[..., TrainResult],
    iters: int,
    checkpoint_path: str,
    segment: int = 20,
    max_restarts: int = 3,
    on_failure: Callable[[Exception, int], None] | None = None,
    **kw,
) -> TrainResult:
    """Run `train_fn` (train() or CompiledModel.train, any kwargs) for
    `iters` epochs total in checkpointed segments; resume across
    failures AND across process restarts.

    on_failure(exc, restart_no): optional hook (logging, device reset).
    Returns the merged TrainResult over all completed segments of THIS
    process (earlier processes' segments are reflected in the resumed
    parameters, not in the returned losses list).
    """
    done = load_progress(checkpoint_path)
    restarts = 0
    results: list[TrainResult] = []
    while done < iters:
        n = min(segment, iters - done)
        resume = (
            _resume_arg(checkpoint_path)
            if (done or restarts) and _ckpt_exists(checkpoint_path)
            else None
        )
        try:
            res = train_fn(
                iters=n,
                checkpoint_path=checkpoint_path,
                resume_from=resume,
                **kw,
            )
        except Exception as exc:  # noqa: BLE001 — recovery surface
            restarts += 1
            if on_failure is not None:
                on_failure(exc, restarts)
            if restarts > max_restarts:
                raise
            continue
        done += n
        _save_progress(checkpoint_path, done)
        results.append(res)
    if not results:
        raise RuntimeError(
            f"nothing to run: {done} epochs already completed (>= {iters}); "
            f"remove {_progress_path(checkpoint_path)} to retrain"
        )
    return _merge(results)


def _merge(rs: list[TrainResult]) -> TrainResult:
    losses = [l for r in rs for l in r.losses]
    accs = [a for r in rs for a in r.accuracies]
    n = sum(max(len(r.losses), 1) for r in rs)
    wt = [max(len(r.losses), 1) / n for r in rs]
    return TrainResult(
        inference_time=float(np.sum([r.inference_time * w for r, w in zip(rs, wt)])),
        total_time=float(np.sum([r.total_time * w for r, w in zip(rs, wt)])),
        max_accuracy=max((r.max_accuracy for r in rs), default=0.0),
        losses=losses,
        accuracies=accs,
        params=rs[-1].params,
        memory_mb=max((r.memory_mb for r in rs), default=0.0),
    )
