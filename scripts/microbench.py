"""Microbenchmarks for aggregation-strategy selection on the accelerator.

Measures the primitive rates that drive the ELL cost model
(gala_tpu/data/ell.py): XLA row gathers, sorted segment-sum scatters,
the fused ELL forward and a one-hot matmul gather.

Run:  python scripts/microbench.py [--n 262144] [--m 2097152] [--f 128]
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gala_tpu.utils.timing import timeit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262144)      # source nodes
    ap.add_argument("--m", type=int, default=2 * 1024 * 1024)  # gather rows
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--k", type=int, default=16)
    args = ap.parse_args()
    n, m, f, k = args.n, args.m, args.f, args.k
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, n, size=m, dtype=np.int32))
    sorted_idx = jnp.sort(idx)

    for dt, name in [(jnp.float32, "f32"), (jnp.bfloat16, "bf16")]:
        x = jnp.asarray(rng.standard_normal((n, f)), dtype=dt)
        bpr = f * x.dtype.itemsize

        # 1. XLA random row gather
        g = jax.jit(lambda x, i: x[i])
        t = timeit(g, x, idx)
        print(f"[{name}] xla gather random : {m/t/1e6:8.1f} Mrows/s "
              f"{m*bpr/t/1e9:7.1f} GB/s")

        # 1b. sorted indices
        t = timeit(g, x, sorted_idx)
        print(f"[{name}] xla gather sorted : {m/t/1e6:8.1f} Mrows/s "
              f"{m*bpr/t/1e9:7.1f} GB/s")

        # 2. XLA scatter-add (segment_sum, sorted)
        v = jnp.asarray(rng.standard_normal((m, f)), dtype=dt)
        s = jax.jit(functools.partial(
            jax.ops.segment_sum, num_segments=n, indices_are_sorted=True))
        t = timeit(s, v, sorted_idx)
        print(f"[{name}] xla segsum sorted : {m/t/1e6:8.1f} Mrows/s "
              f"{m*bpr/t/1e9:7.1f} GB/s")

        # 3. fused ELL forward (gather+einsum+segment_sum) — current prod path
        vk = m // k
        cols2 = idx[: vk * k].reshape(vk, k)
        vals2 = jnp.ones((vk, k), dt)
        vrow = jnp.arange(vk, dtype=jnp.int32) % n

        def ell(x, cols, vals, vrow):
            gth = x[cols]
            part = jnp.einsum("vk,vkf->vf", vals, gth,
                              preferred_element_type=jnp.float32).astype(x.dtype)
            return jax.ops.segment_sum(part, vrow, num_segments=n)

        t = timeit(jax.jit(ell), x, cols2, vals2, vrow)
        print(f"[{name}] xla ell e2e       : {m/t/1e6:8.1f} Medges/s")

        # 4. one-hot matmul gather for a small resident segment
        seg = 4096
        xs = x[:seg]
        idx_s = idx % seg

        def onehot_gather(xs, i):
            oh = jax.nn.one_hot(i, seg, dtype=xs.dtype)
            return jnp.dot(oh, xs, preferred_element_type=jnp.float32)

        t = timeit(jax.jit(onehot_gather), xs, idx_s[:65536])
        print(f"[{name}] onehot mm (64k of 4k seg): {65536/t/1e6:8.1f} Mrows/s")


if __name__ == "__main__":
    main()
