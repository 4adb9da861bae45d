#!/usr/bin/env python
"""Staged-gather designs vs the big-table gather cliff.

The cliff this tests for: XLA row gathers from tables whose padded
footprint is <~90MB ran several times faster per row than from bigger
tables where the executors were first tuned (not yet measured on the
GPU).

Designs tested here (all pure XLA, staged through
`lax.optimization_barrier` so the staging materializes instead of
being algebraically folded back into a big-table gather):

  A  plain      tab[idx]                            (baseline, the cliff)
  B  slice      barrier(tab[lo:hi])[idx - lo]       (is a staged <90MB slice
                                                     gathered at fast rate?)
  C  hot/cold   hot slots from a staged tail slice, cold slots from the
                big table, slots statically split    (heat = out-degree;
                after bell_order relabel hubs are the table tail)
  D  dedup      per-chunk unique ids -> stage u = tab[uniq] (slow, few
                rows) -> seg = u[local] (fast, many rows)

Index distribution: zipf-ish power law (realistic edge sources) and
uniform (worst case), at ogbn-products node counts.

Usage: python scripts/bench_staged_gather.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.utils.timing import timeit

F = 128            # feature width (bf16 -> 256B/row, cannot node-pack)
S = 30_000_000     # gathered rows per trial


def make_idx(n_rows, dist, rng):
    if dist == "uniform":
        return rng.integers(0, n_rows, S).astype(np.int32)
    # power law over nodes, heaviest ids LAST (bell_order puts hubs at
    # the tail): id n-1 is the hottest
    a = 1.05
    z = rng.zipf(a, S * 2)
    z = z[z <= n_rows][:S]
    while z.shape[0] < S:
        extra = rng.zipf(a, S)
        z = np.concatenate([z, extra[extra <= n_rows]])[:S]
    return (n_rows - z).astype(np.int32)


def rate_plain(tab, idx):
    @jax.jit
    def run(tab, idx):
        return tab[idx].astype(jnp.float32).sum()

    t = timeit(run, tab, idx, iters=3, warmup=2)
    return S / t


def rate_slice(tab, idx, hot_rows):
    """All indices clamped into the tail slice — upper bound for staged-
    slice gathering (mechanism probe, not a correctness design)."""
    n = tab.shape[0]
    lo = n - hot_rows
    idx2 = jnp.maximum(idx, lo) - lo

    @jax.jit
    def run(tab, idx2):
        sl = jax.lax.optimization_barrier(
            jax.lax.slice_in_dim(tab, lo, n, axis=0))
        return sl[idx2].astype(jnp.float32).sum()

    t = timeit(run, tab, idx2, iters=3, warmup=2)
    return S / t


def rate_hotcold(tab, idx_np, hot_rows):
    """Static hot/cold slot split: hot slots gather from a staged tail
    slice, cold slots gather (compacted) from the big table and are
    merged back with one sorted scatter."""
    n = tab.shape[0]
    lo = n - hot_rows
    hot_mask = idx_np >= lo
    cold_pos = np.where(~hot_mask)[0].astype(np.int32)
    n_cold = int(cold_pos.shape[0])
    pad = ((n_cold + 127) // 128) * 128 - n_cold
    cold_pos = np.concatenate([cold_pos, np.full(pad, S, np.int32)])  # pad -> drop row
    cold_idx = np.concatenate([idx_np[cold_pos[:n_cold]],
                               np.zeros(pad, np.int32)])
    hot_idx = np.where(hot_mask, idx_np - lo, 0).astype(np.int32)

    j_hot = jnp.asarray(hot_idx)
    j_cold = jnp.asarray(cold_idx)
    j_cpos = jnp.asarray(cold_pos)

    @jax.jit
    def run(tab, j_hot, j_cold, j_cpos):
        sl = jax.lax.optimization_barrier(
            jax.lax.slice_in_dim(tab, lo, n, axis=0))
        seg = sl[j_hot]                                   # (S, F) fast
        cold = tab[j_cold]                                # (C, F) slow, few
        seg = jnp.concatenate([seg, jnp.zeros((1, F), tab.dtype)], axis=0)
        seg = seg.at[j_cpos].set(cold, mode="drop")
        return seg.astype(jnp.float32).sum()

    t = timeit(run, tab, j_hot, j_cold, j_cpos, iters=3, warmup=2)
    frac = 1 - n_cold / S
    return S / t, frac


def rate_dedup(tab, idx_np, chunk):
    """Per-chunk static dedup: stage u = tab[uniq] then seg = u[local]."""
    n_chunks = S // chunk
    uniqs, locals_ = [], []
    max_u = 0
    for c in range(n_chunks):
        part = idx_np[c * chunk:(c + 1) * chunk]
        u, inv = np.unique(part, return_inverse=True)
        uniqs.append(u)
        locals_.append(inv.astype(np.int32))
        max_u = max(max_u, u.shape[0])
    max_u = ((max_u + 127) // 128) * 128
    uq = np.zeros((n_chunks, max_u), np.int32)
    for c, u in enumerate(uniqs):
        uq[c, :u.shape[0]] = u
    loc = np.stack(locals_)
    j_uq, j_loc = jnp.asarray(uq), jnp.asarray(loc)

    @jax.jit
    def run(tab, j_uq, j_loc):
        def body(acc, ul):
            u, l = ul
            stage = jax.lax.optimization_barrier(tab[u])
            seg = stage[l]
            return acc + seg.astype(jnp.float32).sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), (j_uq, j_loc))
        return acc

    t = timeit(run, tab, j_uq, j_loc, iters=3, warmup=2)
    avg_u = np.mean([u.shape[0] for u in uniqs])
    return S / t, avg_u / chunk


def main():
    rng = np.random.default_rng(0)
    for n in (612_258, 2_449_029):
        mb = n * F * 2 / 1e6
        tab = jnp.asarray(rng.standard_normal((n, F)), jnp.bfloat16)
        hot_rows = min(300_000, n // 2)
        for dist in ("zipf", "uniform"):
            idx_np = make_idx(n, dist, rng)
            idx = jnp.asarray(idx_np)
            ra = rate_plain(tab, idx)
            print(f"n={n} ({mb:.0f}MB phys) {dist:8} A plain  "
                  f"{ra/1e6:7.1f} M rows/s", flush=True)
            rb = rate_slice(tab, idx, hot_rows)
            print(f"n={n} ({mb:.0f}MB phys) {dist:8} B slice  "
                  f"{rb/1e6:7.1f} M rows/s (idx clamped to {hot_rows} tail)",
                  flush=True)
            rc, frac = rate_hotcold(tab, idx_np, hot_rows)
            print(f"n={n} ({mb:.0f}MB phys) {dist:8} C hot/cold "
                  f"{rc/1e6:7.1f} M rows/s (hot frac {frac:.2f})", flush=True)
            rd, ufrac = rate_dedup(tab, idx_np, 2_000_000)
            print(f"n={n} ({mb:.0f}MB phys) {dist:8} D dedup  "
                  f"{rd/1e6:7.1f} M rows/s (uniq/chunk {ufrac:.2f})",
                  flush=True)


if __name__ == "__main__":
    main()
