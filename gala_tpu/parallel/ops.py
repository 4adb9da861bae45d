"""SPMD graph ops — called *inside* shard_map.

Each function sees per-shard local arrays (shard_map has already split
the ShardedGraph pytree along 'data').  Aggregation gathers remote source
features with `all_gather` and reduces into local destination
rows with a sorted segment sum; differentiating through shard_map turns
the all_gather into a psum_scatter automatically, which is exactly the
edge-partitioned backward.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

AXIS = "data"


def spmd_spmm(src, dst_local, vals, x_shard, rows_per_shard):
    """out_shard = (A @ X) rows owned by this shard.

    x_shard: (r, F) local feature rows; src holds *global* ids.
    """
    x_full = jax.lax.all_gather(x_shard, AXIS, tiled=True)  # (S*r, F)
    msg = vals[:, None] * x_full[src]
    out = jax.ops.segment_sum(
        msg, dst_local, num_segments=rows_per_shard + 1, indices_are_sorted=False
    )
    return out[:rows_per_shard]


def spmd_spmm_halo(src_halo, dst_local, vals, x_shard, send_idx,
                   rows_per_shard, n_shards, halo, edges_local):
    """out_shard = (A @ X) rows owned by this shard, exchanging only the
    boundary rows peers reference (all_to_all) instead of
    all_gathering the full feature matrix.

    send_idx: (S, H) local rows this shard contributes to each peer;
    src_halo indexes the per-shard [local rows | S*H halo rows] table.
    Edges arrive partitioned [local block | remote block]
    (ShardedGraph.edges_local): the local partition's gather+reduce has
    NO data dependency on the exchange, so XLA's latency-hiding
    scheduler overlaps it with the all_to_all (BASELINE.json: halo
    exchange "overlapped with local neighborhood aggregation").
    Autodiff reverses the all_to_all and turns the gathers into
    scatter-adds, which is exactly the edge-partitioned backward.

    `vals` may be structural weights OR learned per-edge values (GAT) —
    there is no custom VJP here, gradients flow to every operand.
    """
    f = x_shard.shape[1]
    r = rows_per_shard
    el = edges_local
    send = x_shard[send_idx.reshape(-1)].reshape(n_shards, halo, f)
    recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0)
    # local partition (independent of recv -> overlaps the collective)
    xp = jnp.concatenate([x_shard, jnp.zeros((1, f), x_shard.dtype)], axis=0)
    msg_l = vals[:el, None] * xp[src_halo[:el]]
    # each block is CSR-ordered (ascending dst, phantom pads at the end)
    # — the sorted flag selects XLA's faster scatter lowering
    out = jax.ops.segment_sum(
        msg_l, dst_local[:el], num_segments=r + 1, indices_are_sorted=True
    )
    # remote partition reads the exchanged halo rows (padding slots map
    # to halo row 0 with vals 0 — numerically inert)
    halo_tab = recv.reshape(n_shards * halo, f)
    msg_r = vals[el:, None] * halo_tab[src_halo[el:] - r]
    out = out + jax.ops.segment_sum(
        msg_r, dst_local[el:], num_segments=r + 1, indices_are_sorted=True
    )
    return out[:r]


def _halo_table(g, rows):
    """The per-shard [local | halo | zero] gather table: send each
    peer's boundary rows (all_to_all) and append the zero
    phantom row the bell layouts index at n_tab.  Autodiff reverses the
    concat and the all_to_all, so halo-row gradients flow back to their
    owner shards."""
    f = rows.shape[1]
    s, h = g.n_shards, g.halo
    send = rows[g.send_idx.reshape(-1)].reshape(s, h, f)
    recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0)
    return jnp.concatenate(
        [rows, recv.reshape(s * h, f), jnp.zeros((1, f), rows.dtype)],
        axis=0,
    )


def spmd_spmm_bell(g, x_shard):
    """Scatter-free per-shard aggregation: the shard's binned-ELL
    layouts over the halo table run ops.spmm._spmm_bell — the same
    scatter-free custom-VJP reduce as single-chip (forward bins +
    transpose layout backward)."""
    from gala_tpu.ops.spmm import _spmm_bell

    tab = _halo_table(g, x_shard)
    out = _spmm_bell(g.bell.n_out, g.t_bell.n_out, g.bell.view(),
                     g.t_bell.view(), tab)
    return out[: g.rows_per_shard]


def spmd_spmm_ev_bell(g, evals, x_shard):
    """Learned-edge-value aggregation, scatter-free (see
    ops.spmm._spmm_ev_bell): same halo table as spmd_spmm_bell; evals is
    this shard's (Es,) edge vector (ShardedGraph edge order)."""
    from gala_tpu.ops.spmm import _spmm_ev_bell

    tab = _halo_table(g, x_shard)
    out = _spmm_ev_bell(
        g.bell.n_out, g.t_bell.n_out, g.bell.view(), g.t_bell.view(),
        g.bell.rows, g.bell.edge_perm, g.t_bell.edge_perm,
        g.bell.slot_of_edge, evals, tab,
    )
    return out[: g.rows_per_shard]


def spmd_spmm_ev(src, dst_local, evals, x_shard, rows_per_shard):
    """SpMM with learned edge values (GAT path), same gather structure."""
    x_full = jax.lax.all_gather(x_shard, AXIS, tiled=True)
    msg = evals[:, None] * x_full[src]
    out = jax.ops.segment_sum(msg, dst_local, num_segments=rows_per_shard + 1)
    return out[:rows_per_shard]


def spmd_sddvv_add(src, dst_local, vl_shard, vr_shard, rows_per_shard):
    """Per-edge vl[src] + vr[dst]; vl gathered globally, vr local."""
    vl_full = jax.lax.all_gather(vl_shard, AXIS, tiled=True)
    vr_pad = jnp.concatenate([vr_shard, jnp.zeros((1, 1), vr_shard.dtype)])
    return vl_full[src, 0] + vr_pad[dst_local, 0]


def spmd_sddvv_mul(src, dst_local, vl_shard, vr_shard, rows_per_shard):
    """Per-edge vl[src] * vr[dst] — the sparsity-rewrite precompute
    (norm_src * norm_dst edge values) under SPMD."""
    vl_full = jax.lax.all_gather(vl_shard, AXIS, tiled=True)
    vr_pad = jnp.concatenate([vr_shard, jnp.zeros((1, 1), vr_shard.dtype)])
    return vl_full[src, 0] * vr_pad[dst_local, 0]


def spmd_attention(g, x_shard, vl_shard, vr_shard, slope):
    """Sharded fused attention: ONE exchange (halo all_to_all or
    all_gather) of the [x | vl] rows serves both the scores and the
    aggregation — the shard_map analog of the single-chip fused op's
    shared slot gather (gala_tpu.ops.attention).  Per-destination
    softmax stays entirely local (dst-partitioning keeps every softmax
    row on one shard).  Multi-head: head h reads feature columns
    [h*fh, (h+1)*fh) and score column hf+h, H <= 8 static loop.

    Replaces the interp's unfused SDDVV/softmax/SpMM-ev chain (three
    separate gathers of the full feature matrix) under SPMD."""
    hf = x_shard.shape[1]
    nh = vl_shard.shape[1]
    fh = hf // nh
    r = g.rows_per_shard
    f = hf + nh
    if getattr(g, "attn_bell", None) is not None:
        # scatter-free fused path: per-shard attention layouts
        # (ShardedBell over the [local | halo | zero] table) run the
        # single-chip fused slot-space op — masked softmax + weighted
        # reduce with the custom-VJP backward sweeps, no segment
        # scatters.  Fake/padded ids CLAMP to the zero rows (vr row r,
        # table row n_tab), which the occupancy masks make inert.
        from gala_tpu.ops.attention import AttnBell, attention_aggregate

        xx_loc = jnp.concatenate(
            [x_shard, vl_shard.astype(x_shard.dtype)], axis=1
        )
        tab = _halo_table(g, xx_loc)
        ab = AttnBell(
            fwd=g.attn_bell.view(),
            t=g.attn_t_bell.view(),
            rows=g.attn_bell.rows,
            t_rows=g.attn_t_bell.rows,
        )
        vr_pad = jnp.concatenate(
            [vr_shard, jnp.zeros((1, nh), vr_shard.dtype)], axis=0
        )
        out = attention_aggregate(
            g.attn_bell.n_out, g.attn_t_bell.n_out, slope, ab,
            tab[:, :hf], tab[:, hf:], vr_pad,
        )
        return out[:r]
    xx = jnp.concatenate([x_shard, vl_shard.astype(x_shard.dtype)], axis=1)
    if g.use_halo:
        el = g.edges_local
        send = xx[g.send_idx.reshape(-1)].reshape(g.n_shards, g.halo, f)
        recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0)
        xp = jnp.concatenate([xx, jnp.zeros((1, f), xx.dtype)], axis=0)
        rows_l = xp[g.src_halo[:el]]
        rows_r = recv.reshape(-1, f)[g.src_halo[el:] - r]
        rows = jnp.concatenate([rows_l, rows_r], axis=0)   # block order == edge order
    else:
        rows = jax.lax.all_gather(xx, AXIS, tiled=True)[g.src]
    vr_pad = jnp.concatenate(
        [vr_shard, jnp.zeros((1, nh), vr_shard.dtype)], axis=0
    )
    outs = []
    for h in range(nh):
        z = rows[:, hf + h].astype(jnp.float32) + vr_pad[g.dst_local, h]
        z = jnp.where(z > 0, z, slope * z)
        p = spmd_edge_softmax(g.dst_local, z, g.occ, r)
        out_h = jax.ops.segment_sum(
            p[:, None].astype(x_shard.dtype) * rows[:, h * fh : (h + 1) * fh],
            g.dst_local, num_segments=r + 1,
        )[:r]
        outs.append(out_h)
    return jnp.concatenate(outs, axis=1) if nh > 1 else outs[0]


def spmd_edge_softmax(dst_local, logits, vals, rows_per_shard):
    """Softmax over each local destination's incoming edges (edges of one
    destination never cross shards — the point of dst-partitioning)."""
    n_seg = rows_per_shard + 1
    m = jax.ops.segment_max(logits, dst_local, num_segments=n_seg)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    z = jnp.exp(logits - m[dst_local])
    z = jnp.where(vals != 0, z, 0.0)  # mask padded edges
    s = jax.ops.segment_sum(z, dst_local, num_segments=n_seg)
    s = jnp.where(s > 0, s, 1.0)
    return z / s[dst_local]
