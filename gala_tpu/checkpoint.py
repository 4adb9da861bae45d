"""Checkpoint / resume of params + optimizer state.

The reference has no model save/load at all (SURVEY.md §5 — training runs
a fixed iteration count and prints timings).  In JAX this is cheap to add
and required for elastic multi-host recovery, so it is a first-class
capability here.  One format: a NumPy .npz of the pytree's leaves, which
loads on any machine with NumPy.
"""
from __future__ import annotations

import os

import jax
import numpy as np


def _flatten(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> str:
    """Write params (+ optimizer state, step) to `path`.npz; returns the
    file written."""
    leaves, _ = _flatten({"params": params, "opt_state": opt_state, "step": step})
    arrs = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    out = _npz_path(path)
    np.savez(out, **arrs)
    return out


def load_checkpoint(path: str, like):
    """Load a checkpoint saved by save_checkpoint.

    like: an example pytree {'params': ..., 'opt_state': ..., 'step': ...}
    with the structure that was saved; its leaves are replaced by the
    stored arrays.
    """
    leaves, treedef = _flatten(like)
    with np.load(_npz_path(path)) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(data.files)} arrays; "
                f"the structure given has {len(leaves)} leaves"
            )
        new_leaves = [data[f"leaf_{j}"] for j in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
