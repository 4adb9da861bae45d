"""Microbench: sub-cliff node-packed gather vs plain gather.

Hypothesis: the row-gather rate is flat in row width up to 128 lanes (a
33-lane row costs the same gather time as a 128-lane row).  If that
holds, packing P = 128//f nodes per physical row cuts gathered rows
P-fold even BELOW the ~96MB cliff where _pack_factor currently returns
1 — the Reddit-scale GAT forward (28.6M slots from a 58k x 33 table)
would shrink its hot sweeps.

Rows compared, same (cols, vals, x) inputs:
  plain   : x[cols] -> (S, f) -> einsum            (current sub-cliff path)
  packed  : xp[cols // p] -> lane-select -> einsum (_packed_chunk_reduce)

Run on the accelerator:
  python scripts/bench_packed_gather.py --n 58000 --f 33 --nb 1790000 --k 16
  python scripts/bench_packed_gather.py --n 58000 --f 32 --nb 1790000 --k 16
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.ops.spmm import _pack_table, _packed_chunk_reduce
from gala_tpu.utils.timing import timeit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=58_000)
    ap.add_argument("--f", type=int, default=33)
    ap.add_argument("--nb", type=int, default=1_790_000)  # output rows
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--dtype", default="f32", choices=["bf16", "f32"])
    args = ap.parse_args()
    dt = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    n, f, nb, k = args.n, args.f, args.nb, args.k
    rng = np.random.default_rng(0)
    cols = rng.integers(0, n, (nb, k)).astype(np.int32)
    vals = jnp.asarray(rng.normal(size=(nb, k)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32)).astype(dt)
    cols_dev = jnp.asarray(cols)
    itemsize = jnp.dtype(dt).itemsize
    phys_mb = n * ((f + 127) // 128 * 128) * itemsize / 1e6
    s = nb * k
    print(f"table {phys_mb:.1f} MB physical, {s/1e6:.1f}M slots, "
          f"f={f} k={k} {args.dtype}")

    # chunked exactly like the executor (ops/spmm._bell_bin_reduce):
    # a lax.scan over row chunks bounded by the gathered-buffer budget —
    # one-shot forms OOM at these slot counts (14.6GB intermediates)
    rows_c = max((1 << 26) // max(k * 128, 1), 1)
    n_chunks = -(-nb // rows_c)
    nb_pad = n_chunks * rows_c
    cols_p = jnp.zeros((nb_pad, k), jnp.int32).at[:nb].set(cols_dev)
    vals_p = jnp.zeros((nb_pad, k), vals.dtype).at[:nb].set(vals)
    cols_s = cols_p.reshape(n_chunks, rows_c, k)
    vals_s = vals_p.reshape(n_chunks, rows_c, k)
    print(f"chunks: {n_chunks} x {rows_c} rows")

    def plain(cols_s, vals_s, x):
        def body(_, ch):
            c_, v_ = ch
            seg = x[c_.reshape(-1)].reshape(rows_c, k, f)
            return 0, jnp.einsum("vk,vkf->vf", v_, seg,
                                 preferred_element_type=jnp.float32
                                 ).astype(x.dtype)
        _, o = jax.lax.scan(body, 0, (cols_s, vals_s))
        return o

    jf = jax.jit(plain)
    t = timeit(lambda: jf(cols_s, vals_s, x))
    print(f"plain  gather: {t*1e3:8.2f} ms  {s/t/1e6:8.1f}M slots/s")

    def packed_fn(p):
        def run(cols_s, vals_s, xp):
            def body(_, ch):
                c_, v_ = ch
                return 0, _packed_chunk_reduce(c_, v_, xp, p, f, xp.dtype)
            _, o = jax.lax.scan(body, 0, (cols_s, vals_s))
            return o
        return run

    for p in sorted({pp for pp in (2, 128 // max(f, 1), 8) if pp > 1}):
        xp = _pack_table(x, p)
        jp = jax.jit(packed_fn(p))
        t = timeit(lambda: jp(cols_s, vals_s, xp))
        print(f"packed p={p}:   {t*1e3:8.2f} ms  {s/t/1e6:8.1f}M slots/s")

    # correctness on the first chunk only (cheap)
    ref = np.asarray(jax.device_get(jf(cols_s[:1], vals_s[:1], x)), np.float32)
    p = max(128 // max(f, 1), 2)
    got = np.asarray(jax.device_get(
        jax.jit(packed_fn(p))(cols_s[:1], vals_s[:1], _pack_table(x, p))),
        np.float32)
    err = np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-9)
    print(f"packed vs plain rel err: {err:.2e}")


if __name__ == "__main__":
    main()
