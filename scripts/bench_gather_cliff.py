#!/usr/bin/env python
"""Measure the row-gather rate cliff vs PHYSICAL table size.

Hypothesis: the gather slowdown on 'slot-sized' tables (seen where
the executors were first tuned) is driven by the table's physical footprint
(128-lane padded), so (a) bf16 and (b) packing P nodes per physical row
should recover the fast rate for node tables like ogbn-products
(612k x 32 f32 = 313 MB physical).

Usage: python scripts/bench_gather_cliff.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.utils.timing import timeit


def rate(n_rows, f, dtype, n_idx=30_000_000, pack=1):
    """Gather n_idx rows from an (n_rows//pack, f*pack) table."""
    tr = n_rows // pack
    tab = jnp.asarray(
        np.random.default_rng(0).standard_normal((tr, f * pack)), dtype
    )
    idx = jnp.asarray(
        np.random.default_rng(1).integers(0, tr, n_idx).astype(np.int32)
    )

    @jax.jit
    def run(tab, idx):
        return tab[idx].astype(jnp.float32).sum()

    t = timeit(run, tab, idx, iters=4, warmup=2)
    phys_cols = ((f * pack + 127) // 128) * 128
    mb = tr * phys_cols * dtype.dtype.itemsize / 1e6 if hasattr(dtype, "dtype") else (
        tr * phys_cols * jnp.dtype(dtype).itemsize / 1e6
    )
    print(f"table ({tr:>9}, {f*pack:>4}) {jnp.dtype(dtype).name:8} "
          f"phys {mb:7.0f} MB  pack{pack}: {n_idx / t / 1e6:7.1f} M rows/s")
    return n_idx / t


def main():
    f = 32
    for n in (169_343, 612_258, 2_449_029):
        for dtype in (jnp.float32, jnp.bfloat16):
            rate(n, f, dtype)
        rate(n, f, jnp.float32, pack=4)
        rate(n, f, jnp.bfloat16, pack=4)


if __name__ == "__main__":
    main()
