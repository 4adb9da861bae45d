"""Edge-partitioned graph layout for SPMD execution.

The distribution strategy (SURVEY.md §2.4): nodes are range-partitioned
over the 'data' mesh axis; each device owns the edges whose *destination*
falls in its node range (so the aggregation reduction is entirely local)
plus the features of its own nodes.  Source features from other shards
arrive via an all_gather inside shard_map — the cross-chip
analog of the reference's ordered column tiling of the contraction
dimension (reference: src/ops/tiling.h:222-284).

Layout: flat arrays whose leading dimension is divisible by the number of
shards; under shard_map with PartitionSpec('data') each device sees its
contiguous chunk.  Per-shard edge counts are padded to the global max so
shapes are identical on every device (SPMD requirement); padded edges
target the per-shard phantom row.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.data.csr import HostCSR


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedBell:
    """Per-shard binned-ELL layouts with shard-uniform static structure.

    The SPMD local reduce was a sorted segment_sum; this replaces it
    with the scatter-free binned reduce.  This carries one bell layout PER SHARD
    over the per-shard [local rows | halo rows | phantom] feature table,
    stored stacked (leading dim divisible by n_shards) so shard_map's
    P('data') hands each device its own layout; the STATIC structure
    (bin widths/counts, hub shape, slot total) is equalized across
    shards by inert fake rows (phantom slots, zero values) so every
    device traces the same program.

    view() rebuilds an ops.graph.BellDev from the per-shard slices
    inside shard_map; ops.spmm._spmm_bell then provides the scatter-free
    forward AND backward (transpose layout) unchanged.
    """

    flat_cols: jax.Array       # (S * s_total,) int32 into the per-shard table
    bin_vals: tuple            # per bin (S * nb_c, k_c) f32
    big_vals: jax.Array | None  # (S * vb, K_BIG) f32
    big_vrow: jax.Array | None  # (S * vb,) int32
    out_index: jax.Array       # (S * n_out,) int32 bin-order -> row order
    bin_ks: tuple              # static, shard-uniform
    bin_counts: tuple          # static, per-shard rows per bin
    n_big: int                 # static, per-shard hub nodes
    s_total: int               # static, per-shard slots
    n_out: int                 # static, per-shard output rows (incl. zero row)
    # bin-order row ids (hb.order; fake rows carry ids >= the real row
    # count and CLAMP to the table's zero row when used as gather
    # indices) — the attention executor's AttnBell.rows
    rows: jax.Array | None = None  # (S * n_rows_total,) int32
    # learned-edge-value support (ops.spmm._spmm_ev_bell): per-slot
    # shard-edge position (pad slots -> Es) and its inverse (pad edges
    # -> s_total) — slot values gather from the runtime evals vector,
    # and per-edge gradients gather back from per-slot grads; both
    # directions scatter-free
    edge_perm: jax.Array | None = None     # (S * s_total,) int32
    slot_of_edge: jax.Array | None = None  # (S * Es,) int32

    def tree_flatten(self):
        return (
            (self.flat_cols, self.bin_vals, self.big_vals, self.big_vrow,
             self.out_index, self.rows, self.edge_perm, self.slot_of_edge),
            (self.bin_ks, self.bin_counts, self.n_big, self.s_total,
             self.n_out),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        *main, rows, edge_perm, slot_of_edge = children
        return cls(*main, *aux, rows=rows, edge_perm=edge_perm,
                   slot_of_edge=slot_of_edge)

    def view(self):
        """The per-shard BellDev (call inside shard_map, where the
        children are already this shard's slices)."""
        from gala_tpu.ops.graph import BellDev

        return BellDev(
            flat_cols=self.flat_cols,
            bin_vals=self.bin_vals,
            big_vals=self.big_vals,
            big_vrow=self.big_vrow,
            diag=None,
            out_index=self.out_index,
            stage=None,
            bin_ks=self.bin_ks,
            bin_counts=self.bin_counts,
            n_big=self.n_big,
            n_real=self.n_out - 1,
        )


def _build_sharded_bell(edge_lists, n_rows_out: int, n_tab: int,
                        with_rows: bool = False, occupancy: bool = False,
                        eids_lists=None, n_edges: int = 0):
    """Stacked shard-uniform binned-ELL layouts from per-shard edges.

    edge_lists: per shard (dst, src, vals) REAL edges — dst in
    [0, n_rows_out) (this shard's output rows), src in [0, n_tab) (this
    shard's gather-table rows; the table's zero/phantom row sits at
    index n_tab).  Static structure is equalized with fake rows whose
    slots all read the phantom row with value 0: per degree class the
    row count pads to the max across shards; hub nodes/virtual rows pad
    to shared (n_big, vb) targets (every fake hub carries >= 2 virtual
    rows, which deg > BIN_SIZES[-1] forces).
    """
    from gala_tpu.data.csr import coo_to_csr
    from gala_tpu.data.ell import (
        BIN_SIZES,
        K_BIG,
        _bell_classes,
        build_binned_ell,
    )

    if occupancy:
        # attention layouts mask slots by OCCUPANCY, not edge weight
        # (a real edge with weight 0.0 must stay in the softmax —
        # ops/attention.build_attention_bell)
        edge_lists = [
            (dst, src, np.ones(np.asarray(dst).shape[0], np.float32))
            for dst, src, _ in edge_lists
        ]
    n_cls = len(BIN_SIZES)
    stats = []
    for dst, src, vals in edge_lists:
        deg = np.bincount(dst, minlength=n_rows_out)
        cls = _bell_classes(deg)
        cnt = np.bincount(cls, minlength=n_cls + 1)
        big_deg = deg[cls == n_cls]
        vb = int(((big_deg + K_BIG - 1) // K_BIG).sum()) if big_deg.size else 0
        stats.append((cnt, vb))
    cnt_t = np.max([c for c, _ in stats], axis=0)
    nb_t = int(cnt_t[-1])
    vb_t = max(vb for _, vb in stats)

    def _feasible():
        # every shard must be able to reach (nb_t, vb_t) with fake hubs
        # of >= 2 virtual rows each (a fake hub's smallest qualifying
        # degree, > BIN_SIZES[-1], already yields 2 virtual rows); a
        # shard with no hub deficit cannot add virtual rows at all
        for c, vb in stats:
            fn, fv = nb_t - int(c[-1]), vb_t - vb
            if (fn == 0 and fv != 0) or (fn > 0 and fv < 2 * fn):
                return False
        return True

    if nb_t and not _feasible():
        # bump so EVERY shard gets >= 1 fake hub, then retarget vb to
        # each shard's minimum reachable total — always feasible: each
        # deficit is >= 2 per fake hub by maxness, and the last fake hub
        # absorbs any remainder (degree K_BIG * v gives v virtual rows)
        nb_t = max(int(c[-1]) for c, _ in stats) + 1
        vb_t = max(vb + 2 * (nb_t - int(c[-1])) for c, vb in stats)
        assert _feasible(), (nb_t, vb_t, stats)

    hbs, slot_eids = [], []
    for si, ((dst, src, vals), (cnt, vb)) in enumerate(zip(edge_lists, stats)):
        fake_deg = []
        for c in range(n_cls):
            fake_deg.extend([BIN_SIZES[c]] * int(cnt_t[c] - cnt[c]))
        fake_nb = nb_t - int(cnt[-1])
        if fake_nb:
            fake_vb = vb_t - vb
            assert fake_vb >= 2 * fake_nb, (fake_vb, fake_nb)
            fake_deg.extend([2 * K_BIG] * (fake_nb - 1))
            fake_deg.append(K_BIG * (fake_vb - 2 * (fake_nb - 1)))
        n_fake = len(fake_deg)
        eids = (
            np.asarray(eids_lists[si], np.int64)
            if eids_lists is not None else None
        )
        if n_fake:
            fdst = np.repeat(
                np.arange(n_rows_out, n_rows_out + n_fake, dtype=np.int64),
                np.asarray(fake_deg, np.int64),
            )
            dst = np.concatenate([np.asarray(dst, np.int64), fdst])
            src = np.concatenate(
                [np.asarray(src, np.int64), np.full(fdst.shape[0], n_tab)]
            )
            vals = np.concatenate(
                [np.asarray(vals, np.float32),
                 np.zeros(fdst.shape[0], np.float32)]
            )
            if eids is not None:
                eids = np.concatenate(
                    [eids, np.full(fdst.shape[0], n_edges, np.int64)]
                )
        if eids is None:
            g = coo_to_csr(src, dst, vals, n_rows=n_rows_out + n_fake,
                           n_cols=n_tab + 1)
            hbs.append(
                build_binned_ell(g, phantom_col=n_tab, split_diag=False)
            )
            continue
        # edge-value mode: sort manually so each slot's flat_edge maps
        # back to its SHARD-edge position (coo_to_csr hides its sort)
        order_e = np.argsort(dst, kind="stable")
        e_tot = dst.shape[0]
        counts = np.bincount(dst, minlength=n_rows_out + n_fake)
        rp = np.zeros(n_rows_out + n_fake + 1, np.int64)
        np.cumsum(counts, out=rp[1:])
        g = HostCSR(
            n_rows=n_rows_out + n_fake, n_cols=n_tab + 1, row_ptr=rp,
            dst=dst[order_e].astype(np.int32),
            src=src[order_e].astype(np.int32),
            vals=np.asarray(vals, np.float32)[order_e],
        )
        hb = build_binned_ell(g, phantom_col=n_tab, split_diag=False,
                              with_edge_ids=True)
        lookup = np.concatenate(
            [eids[order_e], [n_edges]]
        )  # pad slots: flat_edge == e_tot -> sentinel n_edges
        slot_eids.append(lookup[hb.flat_edge].astype(np.int32))
        hbs.append(hb)

    h0 = hbs[0]
    for h in hbs[1:]:
        assert h.bin_ks == h0.bin_ks and h.bin_counts == h0.bin_counts
        assert h.n_big == h0.n_big
        assert h.flat_cols.shape == h0.flat_cols.shape
        assert h.order.shape == h0.order.shape

    n_rows_total = int(h0.order.shape[0])
    out_idx = []
    for h in hbs:
        inv = np.empty(n_rows_total, np.int64)
        inv[h.order] = np.arange(n_rows_total)
        # fake rows (ids >= n_rows_out) drop; the appended zero row of
        # _bell_raw's assembly (index n_rows_total) backs row n_rows_out
        # — the t-layout phantom / dz zero row
        out_idx.append(
            np.concatenate([inv[:n_rows_out], [n_rows_total]]).astype(np.int32)
        )

    return ShardedBell(
        flat_cols=jnp.asarray(np.concatenate([h.flat_cols for h in hbs])),
        bin_vals=tuple(
            jnp.asarray(np.concatenate([h.bin_vals[i] for h in hbs]))
            for i in range(len(h0.bin_ks))
        ),
        big_vals=(
            jnp.asarray(np.concatenate([h.big_vals for h in hbs]))
            if h0.n_big else None
        ),
        big_vrow=(
            jnp.asarray(np.concatenate([h.big_vrow for h in hbs]))
            if h0.n_big else None
        ),
        out_index=jnp.asarray(np.concatenate(out_idx)),
        bin_ks=h0.bin_ks,
        bin_counts=h0.bin_counts,
        n_big=h0.n_big,
        s_total=int(h0.flat_cols.shape[0]),
        n_out=n_rows_out + 1,
        rows=(
            jnp.asarray(
                np.concatenate([h.order.astype(np.int32) for h in hbs])
            )
            if with_rows else None
        ),
        edge_perm=(
            jnp.asarray(np.concatenate(slot_eids))
            if eids_lists is not None else None
        ),
        slot_of_edge=(
            jnp.asarray(np.concatenate([
                _invert_slot_eids(se, n_edges) for se in slot_eids
            ]))
            if eids_lists is not None else None
        ),
    )


def _invert_slot_eids(slot_eid: np.ndarray, n_edges: int) -> np.ndarray:
    """slot index per shard-edge position (edges not in the layout —
    shard padding — point at the appended zero slot s_total)."""
    s_total = slot_eid.shape[0]
    soe = np.full(n_edges, s_total, np.int32)
    real = slot_eid < n_edges
    soe[slot_eid[real]] = np.nonzero(real)[0].astype(np.int32)
    return soe


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedGraph:
    """dst-partitioned edge list, shard-uniform shapes.

    Duck-types enough of `gala_tpu.ops.graph.Graph` that the op layer
    (spmm / sddvv / edge_softmax) dispatches to the SPMD collective path
    when handed one inside `shard_map` — which lets the IR interpreter
    (gala_tpu.lowering.interp) run any DSL-compiled program multi-chip
    unchanged (see gala_tpu.parallel.compiled)."""

    src: jax.Array        # (S*Es,) int32 global source ids
    dst_local: jax.Array  # (S*Es,) int32 dst - shard_row_offset; Es*[r] = phantom
    vals: jax.Array       # (S*Es,) f32, 0 on padding
    occ: jax.Array        # (S*Es,) f32 occupancy: 1.0 per REAL edge, 0 on
                          # padding — the softmax/attention mask (a real
                          # edge whose WEIGHT is 0.0 must stay in the
                          # softmax; see ops/attention.build_attention_bell)
    deg: jax.Array        # (S*r, 1) f32 in-degrees
    # halo-exchange layout (comm-optimal path): instead of all_gathering
    # the full feature matrix, each shard sends only the boundary rows
    # its peers actually reference (all_to_all).  Each shard's
    # edges are stored [local block | remote block]: edges whose source
    # this shard owns occupy slots [0, El) and never touch the exchange,
    # so XLA's latency-hiding scheduler overlaps the local partition's
    # gather+reduce with the all_to_all (BASELINE.json: halo exchange
    # "overlapped with local neighborhood aggregation").
    src_halo: jax.Array   # (S*Es,) int32; [0,El): local row ids, [El,Es): r + halo slot
    send_idx: jax.Array   # (S*S, H) int32 local rows shard p sends to q

    n_shards: int
    rows_per_shard: int   # r: nodes per shard (padded)
    n_pad: int            # S * r == padded global node count
    n_nodes: int          # real node count
    edges_per_shard: int  # Es = El + Er
    edges_local: int      # El: slots of the local (no-exchange) block
    halo: int             # H: max boundary rows exchanged per shard pair
    use_halo: bool = False  # spmm via halo all_to_all instead of all_gather
    # TP plan as sorted (weight_name, 'col'|'row') items — static aux so
    # interp's FFN lowering sees it at trace time (gala_tpu.parallel.tp)
    tp_plan: tuple = ()
    # scatter-free per-shard binned-ELL layouts over the [local | halo]
    # table (build with use_bell=True; see ShardedBell) — bell drives
    # the forward reduce, t_bell the transpose (backward) reduce
    bell: "ShardedBell | None" = None
    t_bell: "ShardedBell | None" = None
    # fused-attention layouts (use_bell=True + attention=True): the
    # occupancy-masked analogs feeding ops.attention.attention_aggregate
    # inside shard_map (spmd_attention's bell branch)
    attn_bell: "ShardedBell | None" = None
    attn_t_bell: "ShardedBell | None" = None

    # op-layer dispatch markers (see ops/spmm.py, ops/edge.py)
    is_spmd = True
    strategy = "spmd"
    attn = None           # fused single-chip attention layout: n/a

    @property
    def local_rows(self) -> int:
        """Node rows each shard owns — the per-shard leading dim of every
        node-sized tensor inside shard_map."""
        return self.rows_per_shard

    def tree_flatten(self):
        return (
            (self.src, self.dst_local, self.vals, self.occ, self.deg,
             self.src_halo, self.send_idx, self.bell, self.t_bell,
             self.attn_bell, self.attn_t_bell),
            (self.n_shards, self.rows_per_shard, self.n_pad, self.n_nodes,
             self.edges_per_shard, self.edges_local, self.halo, self.use_halo,
             self.tp_plan),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        *main, bell, t_bell, attn_bell, attn_t_bell = children
        return cls(*main, *aux, bell=bell, t_bell=t_bell,
                   attn_bell=attn_bell, attn_t_bell=attn_t_bell)

    @classmethod
    def from_host(cls, g: HostCSR, n_shards: int,
                  use_halo: bool = False,
                  use_bell: bool = False,
                  attention: bool = False,
                  edge_vals: bool = False) -> "ShardedGraph":
        if use_bell:
            use_halo = True  # the bell layouts index the [local|halo] table
        n = g.n_rows
        r = _round_up(max((n + n_shards - 1) // n_shards, 8), 8)
        n_pad = r * n_shards

        shard_of = g.dst // r
        src_of = g.src // r
        is_local = src_of == shard_of
        per_shard_l = np.bincount(shard_of[is_local], minlength=n_shards)
        per_shard_r = np.bincount(shard_of[~is_local], minlength=n_shards)
        el = _round_up(max(int(per_shard_l.max()), 1), 128)
        er = _round_up(max(int(per_shard_r.max()), 1), 128)
        es = el + er

        src = np.zeros((n_shards, es), np.int32)
        dstl = np.full((n_shards, es), r, np.int32)  # phantom row r
        vals = np.zeros((n_shards, es), np.float32)
        reals = np.zeros((n_shards, es), bool)
        for s in range(n_shards):
            sel_l = (shard_of == s) & is_local
            sel_r = (shard_of == s) & ~is_local
            kl, kr = int(sel_l.sum()), int(sel_r.sum())
            src[s, :kl] = g.src[sel_l]
            dstl[s, :kl] = g.dst[sel_l] - s * r
            vals[s, :kl] = g.vals[sel_l]
            reals[s, :kl] = True
            src[s, el : el + kr] = g.src[sel_r]
            dstl[s, el : el + kr] = g.dst[sel_r] - s * r
            vals[s, el : el + kr] = g.vals[sel_r]
            reals[s, el : el + kr] = True

        deg = np.zeros((n_pad, 1), np.float32)
        deg[:n, 0] = np.bincount(g.dst, minlength=n)

        # ---- halo layout: per (owner q <- sender p) boundary row lists.
        # need[s][q] = sorted unique sources shard s reads from shard q.
        need = []
        for s in range(n_shards):
            srcs = src[s][reals[s]]
            owner = srcs // r
            need.append([
                np.unique(srcs[owner == q]) if q != s else np.zeros(0, np.int64)
                for q in range(n_shards)
            ])
        h = max(
            (len(need[s][q]) for s in range(n_shards) for q in range(n_shards)),
            default=1,
        )
        h = _round_up(max(h, 1), 8)
        send_idx = np.zeros((n_shards, n_shards, h), np.int32)
        for p in range(n_shards):
            for q in range(n_shards):
                rows = need[q][p] - p * r       # p-local ids q needs
                send_idx[p, q, : len(rows)] = rows
        # remap sources into the per-shard [local | halo] table:
        # owned u -> u - s*r ; remote u (owner q) -> r + q*h + pos(need[s][q], u)
        src_halo = np.full((n_shards, es), r, np.int32)  # phantom -> a local pad row
        for s in range(n_shards):
            srcs = src[s][reals[s]].astype(np.int64)
            owner = srcs // r
            local = srcs - s * r
            for q in range(n_shards):
                sel = owner == q
                if q == s or not sel.any():
                    continue
                local[sel] = r + q * h + np.searchsorted(need[s][q], srcs[sel])
            dest = np.full(es, r, np.int64)
            dest[np.nonzero(reals[s])[0]] = local
            src_halo[s] = dest.astype(np.int32)

        bell = t_bell = attn_bell = attn_t_bell = None
        if use_bell:
            n_tab = r + n_shards * h
            fwd_lists, t_lists, eids_lists = [], [], []
            for s in range(n_shards):
                m = reals[s]
                fwd_lists.append((dstl[s][m], src_halo[s][m], vals[s][m]))
                t_lists.append((src_halo[s][m], dstl[s][m], vals[s][m]))
                eids_lists.append(np.nonzero(m)[0].astype(np.int64))
            ev_kw = (
                dict(eids_lists=eids_lists, n_edges=es, with_rows=True)
                if edge_vals else {}
            )
            bell = _build_sharded_bell(fwd_lists, r, n_tab, **ev_kw)
            # transpose side: rows = table positions, gathered values =
            # dz rows (dz's appended zero row at index r is the phantom)
            t_bell = _build_sharded_bell(t_lists, n_tab, r, **ev_kw)
            if attention:
                attn_bell = _build_sharded_bell(
                    fwd_lists, r, n_tab, with_rows=True, occupancy=True
                )
                attn_t_bell = _build_sharded_bell(
                    t_lists, n_tab, r, with_rows=True, occupancy=True
                )

        return cls(
            src=jnp.asarray(src.reshape(-1)),
            dst_local=jnp.asarray(dstl.reshape(-1)),
            vals=jnp.asarray(vals.reshape(-1)),
            occ=jnp.asarray(reals.reshape(-1).astype(np.float32)),
            deg=jnp.asarray(deg),
            src_halo=jnp.asarray(src_halo.reshape(-1)),
            send_idx=jnp.asarray(send_idx.reshape(n_shards * n_shards, h)),
            bell=bell,
            t_bell=t_bell,
            attn_bell=attn_bell,
            attn_t_bell=attn_t_bell,
            n_shards=n_shards,
            rows_per_shard=r,
            n_pad=n_pad,
            n_nodes=n,
            edges_per_shard=es,
            edges_local=el,
            halo=h,
            use_halo=use_halo,
        )

    def pad_nodes(self, x: np.ndarray) -> jnp.ndarray:
        x = np.asarray(x)
        pad = self.n_pad - x.shape[0]
        if pad > 0:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return jnp.asarray(x)
