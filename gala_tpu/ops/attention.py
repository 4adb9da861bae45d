"""Fused slot-space graph attention (the GAT hot path).

Replaces the edge-centric chain the reference generates for GAT —
SDDVV-add logits, leaky-relu, per-destination edge softmax, SpMM with
the softmax values (reference: src/codegen/cuda.h:504-953 kernels and
their autograd wrappers, src/codegen/common.h:700-1084) — with ONE
fused op over the binned-ELL slot layout (gala_tpu/data/ell.py):

- the src-side attention terms `vl` ride as extra feature columns, so
  scores and aggregation share a single row gather (the dominant cost);
- MULTI-HEAD is free at the gather level: head h's features occupy
  columns [h*fh, (h+1)*fh) of x and its score column is hf+h — all
  heads share the one (S, hf+H) gather and differ only in the cheap
  per-head streaming softmax/reduce (H <= 8 static Python loop);
- softmax over each destination's neighbors is a *dense masked softmax*
  per degree-class bin (one virtual row per node) — no segment scatter;
  hub nodes (deg > 128) use a small segmented softmax across their
  virtual rows;
- the backward pass RECOMPUTES attention in the transpose layout from
  node-sized tables (saved per-node softmax max/denominator and the
  p·dp row sums), because gathers from slot-sized tables were far
  slower than from node-sized tables where this was first tuned — one
  gather of [dout | vr | m | s | sds] rows replaces any slot
  permutation.

Cost per GAT layer ~= one GCN aggregation each way + a few extra
feature columns per head.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.data.csr import HostCSR
from gala_tpu.data.ell import build_binned_ell
from gala_tpu.ops.graph import BellDev
from gala_tpu.ops.spmm import _pack_factor, _pack_table, slot_reduce

_NEG = -1e30

# slot-elements budget for gathered buffers: above this the op switches
# to chunked gathers with online softmax (nothing S-sized materializes
# or persists as a residual) — the attention analog of the memory-
# bounded bell gathers in ops/spmm._bell_bin_reduce and of the
# reference's ordered column tiling (reference: src/ops/tiling.h:222)
_ATTN_CHUNK_ELEMS = 1 << 26   # physical elements per chunked gather buffer
# Flat-path ceiling.  Default 0: the chunked path with the
# flash-identity backward (see _attn_bwd_chunked) does the same number
# of gather sweeps WITHOUT materializing the (S, hf+H) gth residual or
# saving probabilities, so it dominates the flat path at every scale.
# The flat path remains as the independent test oracle
# (GALA_ATTN_FLAT_ELEMS=536870912 restores the old behavior).
_ATTN_FLAT_ELEMS = int(__import__("os").environ.get(
    "GALA_ATTN_FLAT_ELEMS", "0"
))

# _stage_ctx's canonical 'aligned' branch relies on the attention chunk
# bounds coinciding with the stage tables' S_CHUNK boundaries at 128
# physical lanes — retune EITHER constant and this must be revisited
from gala_tpu.data.ell import S_CHUNK as _S_CHUNK  # noqa: E402

assert _ATTN_CHUNK_ELEMS == _S_CHUNK * 128, (
    "attention chunk bounds must coincide with data.ell.S_CHUNK stage "
    "boundaries at 128 physical lanes (see _stage_ctx)"
)


def _phys_cols(f: int) -> int:
    """Lane count of an f-wide buffer padded to multiples of 128.  The
    chunk budgets count columns this way; they are inherited constants,
    not yet measured on the GPU."""
    return ((f + 127) // 128) * 128


def _float0_like(x):
    return np.zeros(x.shape, jax.dtypes.float0)


def _lrelu(z, slope):
    return jnp.where(z > 0, z, slope * z)


def _chunk_rows(k: int, f: int, chunk_slots: int = 0) -> int:
    """Rows per chunk: ~_ATTN_CHUNK_ELEMS *physical* elements per
    gathered buffer, or the schedule-driven `chunk_slots` granularity
    (the DIR `col_tile` directive, reference: src/ops/tiling.h:222-284)."""
    if chunk_slots:
        return max(chunk_slots // k, 1)
    return max(_ATTN_CHUNK_ELEMS // max(k * _phys_cols(f), 1), 1)


def _chunks(n_rows: int, k: int, f: int, chunk_slots: int = 0):
    """Static chunk bounds [(lo, hi), ...] at _chunk_rows granularity."""
    rows = _chunk_rows(k, f, chunk_slots)
    return [(lo, min(n_rows, lo + rows)) for lo in range(0, n_rows, rows)]


# at/above this many chunks a segment's unrolled barrier chain is
# replaced by a rolled lax.scan: O(1) HLO in chunk count (unrolled
# many-chunk programs cost minutes of compile at products/papers100M
# scale), one live gather temp, at the price of the depth-2
# adjacent-chunk overlap (only triggers where compile time / HLO size
# dominates).  Mirrors ops/spmm._SCAN_MIN_CHUNKS.
_SCAN_MIN_CHUNKS = 16


def _rolled_map(cols_seg, rows, k, per_row, body, rows_per_chunk,
                pad_vals=None):
    """Rolled per-chunk map: reshape this segment's slot columns and
    per-row operands into (n_chunks, r, ...) and lax.scan `body` over
    them.  body(cols_c, *per_row_c) -> tuple of (r, ...) outputs, which
    are restacked to (rows, ...) with the tail padding dropped.
    pad_vals: per-operand tail fill (default zeros) — e.g. 1.0 for
    softmax denominators so padded rows never divide by zero."""
    n_chunks = -(-rows // rows_per_chunk)
    pad = n_chunks * rows_per_chunk - rows
    if pad:
        cols_seg = jnp.concatenate(
            [cols_seg, jnp.zeros(pad * k, cols_seg.dtype)]
        )
        per_row = tuple(
            jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:],
                             (pad_vals or {}).get(i, 0), a.dtype)]
            )
            for i, a in enumerate(per_row)
        )
    cols2 = cols_seg.reshape(n_chunks, rows_per_chunk, k)
    per2 = tuple(
        a.reshape(n_chunks, rows_per_chunk, *a.shape[1:]) for a in per_row
    )

    def sbody(_, inp):
        return 0, body(inp[0], *inp[1:])

    _, outs = jax.lax.scan(sbody, 0, (cols2,) + per2)
    return tuple(
        o.reshape(n_chunks * rows_per_chunk, *o.shape[2:])[:rows]
        for o in outs
    )


def _rolled_acc(cols_seg, rows, k, per_row, carry0, body, rows_per_chunk):
    """Rolled hub accumulation: like _rolled_map but body(carry,
    cols_c, *per_row_c) -> carry threads segment-level accumulators
    (online-softmax state / gradient sums) through the scan carry.
    Padded tail rows carry zeroed masks so they contribute nothing."""
    n_chunks = -(-rows // rows_per_chunk)
    pad = n_chunks * rows_per_chunk - rows
    if pad:
        cols_seg = jnp.concatenate(
            [cols_seg, jnp.zeros(pad * k, cols_seg.dtype)]
        )
        per_row = tuple(
            jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
            for a in per_row
        )
    cols2 = cols_seg.reshape(n_chunks, rows_per_chunk, k)
    per2 = tuple(
        a.reshape(n_chunks, rows_per_chunk, *a.shape[1:]) for a in per_row
    )

    def sbody(carry, inp):
        return body(carry, inp[0], *inp[1:]), 0

    carry, _ = jax.lax.scan(sbody, carry0, (cols2,) + per2)
    return carry


def _gather_slots(table, cols, p, fw, stage_pair=None):
    """Gather (rows, k, fw) slot rows from `table`; when p > 1 the table
    is node-packed (p nodes per physical row, see ops/spmm._pack_factor)
    and the slot's lane window is selected elementwise — every operand
    stays 2-D (3-D small-minor operands tile-pad up to 64x).  When
    `stage_pair` = (uniq, local) is given the gather runs two-level
    through a barrier-staged dedup table (see ops/spmm._STAGE_MIN_BYTES)."""
    rows, k = cols.shape
    if stage_pair is not None:
        uniq, local = stage_pair
        st = jax.lax.optimization_barrier(table[uniq])
        return st[local.reshape(rows, k)]
    if p == 1:
        return table[cols]
    flat = cols.reshape(-1)
    seg2 = table[flat // p]
    lane = (flat % p)[:, None]
    acc = jnp.zeros((rows * k, fw), seg2.dtype)
    for c in range(p):
        acc = acc + jnp.where(
            lane == c, jax.lax.slice_in_dim(seg2, c * fw, (c + 1) * fw, axis=1), 0
        )
    return acc.reshape(rows, k, fw)


def _stage_ctx(bell, table, p, fw):
    """Per-segment (uniq, local) stage-pair lists when the staged
    two-level gather applies to this pass (see ops/spmm): table over the
    cliff, no packing, and fw narrow enough that the attention chunk
    bounds coincide with the canonical stage boundaries."""
    from gala_tpu.ops.spmm import _STAGE_MIN_BYTES, _split_stage

    itemsize = jnp.dtype(table.dtype).itemsize
    tab_bytes = table.shape[0] * _phys_cols(fw) * itemsize
    # boundary coincidence: canonical stage tables (S_CHUNK slots) line
    # up with the attention chunk bounds only at 128 physical lanes;
    # schedule-driven tables are built on chunk_slots boundaries, which
    # _chunks reproduces for ANY width
    aligned = bell.chunk_slots or _phys_cols(fw) == 128
    if (bell.stage is None or p != 1 or not aligned
            or tab_bytes <= _STAGE_MIN_BYTES):
        return None
    return _split_stage(bell)


class _Pipeline:
    """Bounded-overlap chunk sequencing.  An optimization_barrier ties
    each chunk's outputs to the gather-table reference a LATER chunk
    reads; alternating between two references gives pipeline depth 2:
    at most ~2 chunk buffers live (without barriers XLA holds EVERY
    chunk's 256M gather temp at once and OOMs), while gather and
    compute of adjacent chunks still overlap."""

    def __init__(self, table):
        self.tabs = [table, table]
        self.i = 0

    def table(self):
        return self.tabs[self.i % 2]

    def step(self, *outs):
        res = jax.lax.optimization_barrier((self.tabs[self.i % 2],) + outs)
        self.tabs[self.i % 2] = res[0]
        self.i += 1
        return res[1:]


# --------------------------------------------------------------------------- #
# host build
# --------------------------------------------------------------------------- #
def build_attention_bell(g: HostCSR):
    """(forward layout, transpose layout).

    Self loops stay in the layout (GAT attends over neighbors + self, the
    reference keeps them as ordinary edges).  The layouts are built with
    OCCUPANCY values (1.0 per real edge): attention scores ignore edge
    weights and the kernels use bin_vals/big_vals purely as slot masks —
    reusing structural values would silently drop a real edge whose
    weight happens to be exactly 0.0 from the softmax."""
    occ = np.ones_like(g.vals, dtype=np.float32)
    g1 = dataclasses.replace(g, vals=occ)
    hb = build_binned_ell(g1, split_diag=False)

    order_t = np.argsort(g.src, kind="stable")
    counts = np.bincount(g.src, minlength=g.n_cols)
    rp = np.zeros(g.n_cols + 1, np.int64)
    np.cumsum(counts, out=rp[1:])
    gt = HostCSR(
        n_rows=g.n_cols, n_cols=g.n_rows, row_ptr=rp,
        dst=g.src[order_t].astype(np.int32),
        src=g.dst[order_t].astype(np.int32),
        vals=occ,
    )
    hbt = build_binned_ell(gt, split_diag=False)
    return hb, hbt


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class AttnBell:
    """Device arrays of the fused-attention layout."""

    fwd: BellDev
    t: BellDev
    rows: jax.Array | None    # (n_real,) node id per fwd bin position; None = identity
    t_rows: jax.Array | None  # (c_real,) node id per t bin position; None = identity

    def tree_flatten(self):
        return (self.fwd, self.t, self.rows, self.t_rows), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_host(cls, g: HostCSR, n_pad: int, c_pad: int,
                  chunk_slots: int = 0) -> "AttnBell":
        from gala_tpu.data.ell import S_CHUNK, build_stage_tables
        from gala_tpu.ops.graph import _STAGE_BUILD_BYTES, _STAGE_MAX_UNIQ_FRAC

        hb, hbt = build_attention_bell(g)

        def _stage(h, rows):
            if rows * 128 * 2 <= _STAGE_BUILD_BYTES:
                return None
            st = build_stage_tables(h, chunk_slots or S_CHUNK)
            return st if st.uniq_frac < _STAGE_MAX_UNIQ_FRAC else None

        return cls(
            fwd=BellDev.from_host(hb, n_pad, g.n_rows,
                                  stage_tables=_stage(hb, g.n_cols),
                                  chunk_slots=chunk_slots),
            t=BellDev.from_host(hbt, c_pad, g.n_cols,
                                stage_tables=_stage(hbt, g.n_rows),
                                chunk_slots=chunk_slots),
            rows=None if hb.identity_order else jnp.asarray(hb.order.astype(np.int32)),
            t_rows=None if hbt.identity_order else jnp.asarray(hbt.order.astype(np.int32)),
        )


# --------------------------------------------------------------------------- #
# device op
# --------------------------------------------------------------------------- #
def _assemble(parts, bell, n_pad, f, dtype):
    """Concat bin-order parts and map to global padded node order."""
    out = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    if bell.out_index is not None:
        out = jnp.concatenate([out, jnp.zeros((1, f), dtype)], axis=0)
        return out[bell.out_index]
    pad = n_pad - out.shape[0]
    if pad > 0:
        out = jnp.concatenate([out, jnp.zeros((pad, f), dtype)], axis=0)
    return out


def _head_softmax(seg, w, vr_rows, hf, fh, h, slope):
    """Dense masked softmax + weighted reduce for head h of one bin
    chunk.  seg: (rows, k, hf+H) gathered [x | vl] rows; w: (rows, k)
    slot mask; vr_rows: (rows, H).  Returns (out_h, p, m, s)."""
    z = seg[..., hf + h].astype(jnp.float32) + vr_rows[:, h : h + 1].astype(jnp.float32)
    z = jnp.where(w != 0, _lrelu(z, slope), _NEG)
    m = jnp.maximum(jnp.max(z, axis=1, keepdims=True), _NEG / 2)
    p = jnp.where(w != 0, jnp.exp(z - m), 0.0)
    s = jnp.sum(p, axis=1, keepdims=True)
    s = jnp.where(s > 0, s, 1.0)
    p = p / s
    out = slot_reduce(p.astype(seg.dtype), seg[..., h * fh : (h + 1) * fh],
                      seg.dtype)
    return out, p, m, s


def _head_softmax_pos(seg, w, vr_rows, hf, fh, h, slope):
    """_head_softmax variant that additionally accumulates the
    positive-preactivation statistics the flash-identity backward needs
    (see _attn_bwd_chunked):
      outpos = sum_{zpre>0} p * x-slice   (f32)
      spos   = sum_{zpre>0} p
    Returns (out32, outpos32, m, s, spos) with out32 kept in f32 — the
    caller casts once after assembly and saves the f32 as residual so
    sds = <dout, out> is exact."""
    zpre = seg[..., hf + h].astype(jnp.float32) + vr_rows[:, h : h + 1].astype(
        jnp.float32
    )
    z = jnp.where(w != 0, _lrelu(zpre, slope), _NEG)
    m = jnp.maximum(jnp.max(z, axis=1, keepdims=True), _NEG / 2)
    p = jnp.where(w != 0, jnp.exp(z - m), 0.0)
    s = jnp.sum(p, axis=1, keepdims=True)
    s = jnp.where(s > 0, s, 1.0)
    p = p / s
    ppos = jnp.where(zpre > 0, p, 0.0)
    xs = seg[..., h * fh : (h + 1) * fh]
    out32 = slot_reduce(p.astype(xs.dtype), xs, jnp.float32)
    outpos32 = slot_reduce(ppos.astype(xs.dtype), xs, jnp.float32)
    spos = jnp.sum(ppos, axis=1, keepdims=True)
    return out32, outpos32, m, s, spos


def _attn_fwd_raw(ab: AttnBell, x, vl, vr, slope, n_pad):
    hf = x.shape[1]
    nh = vl.shape[1]
    fh = hf // nh
    b = ab.fwd
    xx = jnp.concatenate([x, vl.astype(x.dtype)], axis=1)
    gth = xx[b.flat_cols]                                   # (S, hf+H) — hot
    vr_bin = vr if ab.rows is None else vr[ab.rows]         # (>=n_real, H)

    parts, probs, ms, ss, off, r0 = [], [], [], [], 0, 0
    for k, nb, w in zip(b.bin_ks, b.bin_counts, b.bin_vals):
        seg = jax.lax.slice_in_dim(gth, off, off + nb * k).reshape(nb, k, hf + nh)
        outs_h, probs_h, m_h, s_h = [], [], [], []
        for h in range(nh):
            o, p, m, s = _head_softmax(
                seg, w, vr_bin[r0 : r0 + nb], hf, fh, h, slope
            )
            outs_h.append(o)
            probs_h.append(p)
            m_h.append(m)
            s_h.append(s)
        parts.append(jnp.concatenate(outs_h, axis=1) if nh > 1 else outs_h[0])
        probs.append(probs_h)
        ms.append(jnp.concatenate(m_h, axis=1) if nh > 1 else m_h[0])
        ss.append(jnp.concatenate(s_h, axis=1) if nh > 1 else s_h[0])
        off += nb * k
        r0 += nb
    if b.n_big:
        vb, kb = b.big_vals.shape
        seg = jax.lax.slice_in_dim(gth, off, off + vb * kb).reshape(vb, kb, hf + nh)
        vr_big = vr_bin[r0 + b.big_vrow]                        # (vb, H)
        outs_h, probs_h, m_h, s_h = [], [], [], []
        for h in range(nh):
            z = _lrelu(
                seg[..., hf + h].astype(jnp.float32)
                + vr_big[:, h : h + 1].astype(jnp.float32),
                slope,
            )
            z = jnp.where(b.big_vals != 0, z, _NEG)
            # max/sum across a hub node's virtual rows (tiny segment ops)
            m = jax.ops.segment_max(
                jnp.max(z, axis=1), b.big_vrow,
                num_segments=b.n_big, indices_are_sorted=True,
            )
            m = jnp.maximum(m, _NEG / 2)
            p = jnp.where(b.big_vals != 0, jnp.exp(z - m[b.big_vrow][:, None]), 0.0)
            s = jax.ops.segment_sum(
                jnp.sum(p, axis=1), b.big_vrow,
                num_segments=b.n_big, indices_are_sorted=True,
            )
            s = jnp.where(s > 0, s, 1.0)
            p = p / s[b.big_vrow][:, None]
            part = slot_reduce(
                p.astype(x.dtype), seg[..., h * fh : (h + 1) * fh], x.dtype
            )
            outs_h.append(
                jax.ops.segment_sum(
                    part, b.big_vrow, num_segments=b.n_big, indices_are_sorted=True
                )
            )
            probs_h.append(p)
            m_h.append(m[:, None])
            s_h.append(s[:, None])
        parts.append(jnp.concatenate(outs_h, axis=1) if nh > 1 else outs_h[0])
        probs.append(probs_h)
        ms.append(jnp.concatenate(m_h, axis=1) if nh > 1 else m_h[0])
        ss.append(jnp.concatenate(s_h, axis=1) if nh > 1 else s_h[0])
        off += vb * kb
    out = _assemble(parts, b, n_pad, hf, x.dtype)
    # per-node softmax stats in GLOBAL order (node-sized backward tables)
    m_node = _assemble(ms, b, n_pad, nh, jnp.float32)
    s_node = _assemble(ss, b, n_pad, nh, jnp.float32)
    return out, gth, probs, vr_bin, m_node, s_node


def _attn_fwd_chunked(ab: AttnBell, x, vl, vr, slope, n_pad,
                      need_flash: bool = True):
    """Memory-bounded forward: per-bin chunked gathers; the hub class
    accumulates with an online (rescaling) softmax so no S-sized buffer
    ever materializes.  Returns per-node stats only.

    With need_flash the forward additionally accumulates the flash-identity statistics out+ = sum_{zpre>0} p*x
    and s+ = sum_{zpre>0} p per destination — node-sized residuals that
    let the backward compute sds and dvr WITHOUT re-gathering the slot
    table, cutting a full S-slot gather
    sweep per layer (see _attn_bwd_chunked).

    need_flash=False (the custom_vjp PRIMAL, i.e. inference) skips the
    pos-stat accumulation entirely: it would double the per-slot reduce
    (a second slot reduce per chunk per head) and widen every
    scan/fori carry — work XLA cannot dead-code-eliminate out of a
    rolled loop — for residuals only the backward reads."""
    hf = x.shape[1]
    nh = vl.shape[1]
    fh = hf // nh
    b = ab.fwd
    xx = jnp.concatenate([x, vl.astype(x.dtype)], axis=1)
    vr_bin = vr if ab.rows is None else vr[ab.rows]
    p_x = _pack_factor(xx.shape[0], hf + nh, jnp.dtype(xx.dtype).itemsize)
    pl = _Pipeline(_pack_table(xx, p_x) if p_x > 1 else xx)
    sctx = _stage_ctx(b, xx, p_x, hf + nh)

    use_flash = need_flash

    parts, ms, ss, off, r0, si = [], [], [], 0, 0, 0
    pos_parts, spos_parts = [], []
    for k, nb, w in zip(b.bin_ks, b.bin_counts, b.bin_vals):
        rows_c = _chunk_rows(k, hf + nh, b.chunk_slots)
        if sctx is None and -(-nb // rows_c) >= _SCAN_MIN_CHUNKS:
            # many-chunk bin: rolled lax.scan (see _SCAN_MIN_CHUNKS)
            def fwd_body(cols_c, wv, vr_c):
                seg = _gather_slots(pl.table(), cols_c, p_x, hf + nh)
                outs_h, m_h, s_h, op_h, sp_h = [], [], [], [], []
                for h in range(nh):
                    if use_flash:
                        o32, op32, m, s, sp = _head_softmax_pos(
                            seg, wv, vr_c, hf, fh, h, slope
                        )
                        op_h.append(op32)
                        sp_h.append(sp)
                    else:
                        o32, _, m, s = _head_softmax(
                            seg, wv, vr_c, hf, fh, h, slope
                        )
                    outs_h.append(o32)
                    m_h.append(m)
                    s_h.append(s)
                cat = lambda xs: jnp.concatenate(xs, axis=1) if nh > 1 else xs[0]
                if use_flash:
                    return cat(outs_h), cat(m_h), cat(s_h), cat(op_h), cat(sp_h)
                return cat(outs_h), cat(m_h), cat(s_h)

            cols_seg = jax.lax.slice_in_dim(b.flat_cols, off, off + nb * k)
            outs_scan = _rolled_map(
                cols_seg, nb, k, (w, vr_bin[r0 : r0 + nb]), fwd_body, rows_c
            )
            if use_flash:
                o_b, m_b, s_b, op_b, sp_b = outs_scan
                pos_parts.append(op_b)
                spos_parts.append(sp_b)
            else:
                o_b, m_b, s_b = outs_scan
            parts.append(o_b)
            ms.append(m_b)
            ss.append(s_b)
            off += nb * k
            r0 += nb
            si += 1
            continue
        outs, mcs, scs, opcs, spcs = [], [], [], [], []
        for ci, (lo, hi) in enumerate(_chunks(nb, k, hf + nh, b.chunk_slots)):
            cols = jax.lax.slice_in_dim(
                b.flat_cols, off + lo * k, off + hi * k
            ).reshape(hi - lo, k)
            seg = _gather_slots(pl.table(), cols, p_x, hf + nh,
                                sctx[si][ci] if sctx else None)
            wv = jax.lax.slice_in_dim(w, lo, hi)
            outs_h, m_h, s_h, op_h, sp_h = [], [], [], [], []
            for h in range(nh):
                if use_flash:
                    o32, op32, m, s, sp = _head_softmax_pos(
                        seg, wv, vr_bin[r0 + lo : r0 + hi], hf, fh, h, slope
                    )
                    op_h.append(op32)
                    sp_h.append(sp)
                else:
                    o32, _, m, s = _head_softmax(
                        seg, wv, vr_bin[r0 + lo : r0 + hi], hf, fh, h, slope
                    )
                outs_h.append(o32)
                m_h.append(m)
                s_h.append(s)
            cat = lambda xs: jnp.concatenate(xs, axis=1) if nh > 1 else xs[0]
            if use_flash:
                o_c, m, s, op_c, sp_c = pl.step(
                    cat(outs_h), cat(m_h), cat(s_h), cat(op_h), cat(sp_h)
                )
                opcs.append(op_c)
                spcs.append(sp_c)
            else:
                o_c, m, s = pl.step(cat(outs_h), cat(m_h), cat(s_h))
            outs.append(o_c)
            mcs.append(m)
            scs.append(s)
        cat0 = lambda xs: jnp.concatenate(xs) if len(xs) > 1 else xs[0]
        parts.append(cat0(outs))
        ms.append(cat0(mcs))
        ss.append(cat0(scs))
        if use_flash:
            pos_parts.append(cat0(opcs))
            spos_parts.append(cat0(spcs))
        off += nb * k
        r0 += nb
        si += 1
    if b.n_big:
        vb, kb = b.big_vals.shape

        def hub_chunk(m, s, acc, sp, accp, seg, wv, vrow):
            """One online-softmax hub update (rescaling accumulators);
            sp/accp carry the flash pos-statistics with the SAME
            rescaling as s/acc — skipped entirely (None carries) when
            the flash residuals are not needed (inference primal): the
            accp reduce doubles the per-slot reduce work."""
            m_hs, s_hs, acc_hs, sp_hs, accp_hs = [], [], [], [], []
            for h in range(nh):
                zpre = seg[..., hf + h].astype(jnp.float32) + vr_bin[
                    r0 + vrow, h
                ][:, None].astype(jnp.float32)
                z = jnp.where(wv != 0, _lrelu(zpre, slope), _NEG)
                m_c = jax.ops.segment_max(
                    jnp.max(z, axis=1), vrow, num_segments=b.n_big,
                    indices_are_sorted=True,
                )
                m_h = m[:, h]
                m_new = jnp.maximum(m_h, jnp.maximum(m_c, _NEG))
                p = jnp.where(wv != 0, jnp.exp(z - m_new[vrow][:, None]), 0.0)
                s_c = jax.ops.segment_sum(
                    jnp.sum(p, axis=1), vrow, num_segments=b.n_big,
                    indices_are_sorted=True,
                )
                acc_c = jax.ops.segment_sum(
                    slot_reduce(p.astype(x.dtype),
                                seg[..., h * fh : (h + 1) * fh], jnp.float32),
                    vrow, num_segments=b.n_big, indices_are_sorted=True,
                )
                scale = jnp.exp(m_h - m_new)
                s_hs.append(s[:, h] * scale + s_c)
                acc_hs.append(
                    acc[:, h * fh : (h + 1) * fh] * scale[:, None] + acc_c
                )
                m_hs.append(m_new)
                if use_flash:
                    ppos = jnp.where(zpre > 0, p, 0.0)
                    sp_c = jax.ops.segment_sum(
                        jnp.sum(ppos, axis=1), vrow, num_segments=b.n_big,
                        indices_are_sorted=True,
                    )
                    accp_c = jax.ops.segment_sum(
                        slot_reduce(ppos.astype(x.dtype),
                                    seg[..., h * fh : (h + 1) * fh],
                                    jnp.float32),
                        vrow, num_segments=b.n_big, indices_are_sorted=True,
                    )
                    sp_hs.append(sp[:, h] * scale + sp_c)
                    accp_hs.append(
                        accp[:, h * fh : (h + 1) * fh] * scale[:, None] + accp_c
                    )
            m = jnp.stack(m_hs, axis=1)
            s = jnp.stack(s_hs, axis=1)
            acc = jnp.concatenate(acc_hs, axis=1) if nh > 1 else acc_hs[0]
            if not use_flash:
                return m, s, acc
            sp = jnp.stack(sp_hs, axis=1)
            accp = jnp.concatenate(accp_hs, axis=1) if nh > 1 else accp_hs[0]
            return m, s, acc, sp, accp

        m = jnp.full((b.n_big, nh), _NEG, jnp.float32)
        s = jnp.zeros((b.n_big, nh), jnp.float32)
        acc = jnp.zeros((b.n_big, hf), jnp.float32)
        if use_flash:
            sp = jnp.zeros((b.n_big, nh), jnp.float32)
            accp = jnp.zeros((b.n_big, hf), jnp.float32)
            carry0 = (m, s, acc, sp, accp)
        else:
            sp = accp = None
            carry0 = (m, s, acc)
        rows_c = _chunk_rows(kb, hf + nh, b.chunk_slots)
        if sctx is None and -(-vb // rows_c) >= _SCAN_MIN_CHUNKS:
            def hub_body(carry, cols_c, wv, vrow):
                seg = _gather_slots(pl.table(), cols_c, p_x, hf + nh)
                if use_flash:
                    return hub_chunk(*carry, seg, wv, vrow)
                m_, s_, acc_ = carry
                return hub_chunk(m_, s_, acc_, None, None, seg, wv, vrow)

            cols_seg = jax.lax.slice_in_dim(b.flat_cols, off, off + vb * kb)
            carry = _rolled_acc(
                cols_seg, vb, kb, (b.big_vals, b.big_vrow),
                carry0, hub_body, rows_c,
            )
            if use_flash:
                m, s, acc, sp, accp = carry
            else:
                m, s, acc = carry
        else:
            carry = carry0
            for ci, (lo, hi) in enumerate(
                _chunks(vb, kb, hf + nh, b.chunk_slots)
            ):
                cols = jax.lax.slice_in_dim(
                    b.flat_cols, off + lo * kb, off + hi * kb
                ).reshape(hi - lo, kb)
                seg = _gather_slots(pl.table(), cols, p_x, hf + nh,
                                    sctx[si][ci] if sctx else None)
                wv = jax.lax.slice_in_dim(b.big_vals, lo, hi)
                vrow = jax.lax.slice_in_dim(b.big_vrow, lo, hi)
                if use_flash:
                    carry = hub_chunk(*carry, seg, wv, vrow)
                else:
                    m_, s_, acc_ = carry
                    carry = hub_chunk(m_, s_, acc_, None, None, seg, wv, vrow)
                carry = pl.step(*carry)
            if use_flash:
                m, s, acc, sp, accp = carry
            else:
                m, s, acc = carry
        s = jnp.where(s > 0, s, 1.0)
        per_head = lambda a: jnp.concatenate(
            [a[:, h * fh : (h + 1) * fh] / s[:, h : h + 1] for h in range(nh)],
            axis=1,
        ) if nh > 1 else a / s
        out_big = per_head(acc)
        parts.append(out_big if use_flash else out_big.astype(x.dtype))
        if use_flash:
            pos_parts.append(per_head(accp))
            spos_parts.append(sp / s)
        ms.append(jnp.maximum(m, _NEG / 2))
        ss.append(s)
    # bins accumulated f32 on the flash path; one cast after assembly
    out32_node = _assemble(parts, b, n_pad, hf, jnp.float32) if use_flash else None
    out = (
        out32_node.astype(x.dtype) if use_flash
        else _assemble(parts, b, n_pad, hf, x.dtype)
    )
    m_bin = jnp.concatenate(ms) if len(ms) > 1 else ms[0]   # bin order
    s_bin = jnp.concatenate(ss) if len(ss) > 1 else ss[0]
    m_node = _assemble([m_bin], b, n_pad, nh, jnp.float32)    # global order
    s_node = _assemble([s_bin], b, n_pad, nh, jnp.float32)
    if use_flash:
        outpos_node = _assemble(pos_parts, b, n_pad, hf, jnp.float32)
        spos_node = _assemble(spos_parts, b, n_pad, nh, jnp.float32)
        flash = (out32_node, outpos_node, spos_node)
    else:
        flash = None
    return out, vr_bin, m_bin, s_bin, m_node, s_node, flash


def _attn_bwd_chunked(ab: AttnBell, x, vl, vr, m_node, s_node, slope, dout,
                      c_pad, flash):
    """Memory-bounded backward.

    With `flash` = (out32, outpos, spos) forward residuals, the S-slot
    gather sweep that would recompute probabilities is REPLACED by
    node-sized flash identities:
      sds(r,h)  = <dout_r, out_r>_h          (flash-attention's D trick:
                  sum_e p*dp = <dout, sum_e p*x> = <dout, out>)
      PDP+(r,h) = <dout_r, out+_r>_h
      dvr       = (1-slope) * (PDP+ - sds * s+)
    (derivation: lrelu'(z) = slope + (1-slope)*[z>0], so
     A = sum p*dp*lrelu' = slope*sds + (1-slope)*PDP+ and
     B = sum p*lrelu'    = slope*1   + (1-slope)*s+; dvr = A - sds*B.)
    This cuts the 3-gather-sweep GAT layer to 2 sweeps.  Pass 2
    (transpose layout) is plain accumulation, chunked the same way."""
    hf = x.shape[1]
    nh = vl.shape[1]
    fh = hf // nh
    out32, outpos, spos = flash
    do32 = dout.astype(jnp.float32)
    sds_cols, pdp_cols = [], []
    for h in range(nh):
        sl = slice(h * fh, (h + 1) * fh)
        sds_cols.append(
            jnp.sum(do32[:, sl] * out32[:, sl], axis=1, keepdims=True)
        )
        pdp_cols.append(
            jnp.sum(do32[:, sl] * outpos[:, sl], axis=1, keepdims=True)
        )
    sds_node = jnp.concatenate(sds_cols, axis=1) if nh > 1 else sds_cols[0]
    pdp_pos = jnp.concatenate(pdp_cols, axis=1) if nh > 1 else pdp_cols[0]
    dvr = (1.0 - slope) * (pdp_pos - sds_node * spos)
    return _attn_bwd_pass2(
        ab, x, vl, vr, m_node, s_node, sds_node, dvr, slope, dout, c_pad
    )


def _attn_bwd_pass2(ab, x, vl, vr, m_node, s_node, sds_node, dvr, slope,
                    dout, c_pad):
    """Pass 2 (transpose layout): one chunked plain-accumulation gather
    sweep over the [dout | vr | m | s | sds] destination table emitting
    [dx | dvl] source rows; dvr passes through from pass 1 (or the
    flash identities)."""
    hf = x.shape[1]
    nh = vl.shape[1]
    fh = hf // nh
    t = ab.t
    w_tab = jnp.concatenate(
        [dout.astype(jnp.float32), vr.astype(jnp.float32),
         m_node, s_node, sds_node],
        axis=1,
    )
    vl_t = vl.astype(jnp.float32) if ab.t_rows is None else vl[ab.t_rows].astype(jnp.float32)
    x_t = x.astype(jnp.float32) if ab.t_rows is None else x[ab.t_rows].astype(jnp.float32)
    wt = hf + 4 * nh
    p_w = _pack_factor(w_tab.shape[0], wt, jnp.dtype(w_tab.dtype).itemsize)
    pl2 = _Pipeline(_pack_table(w_tab, p_w) if p_w > 1 else w_tab)
    sctx2 = _stage_ctx(t, w_tab, p_w, wt)

    parts, off, r0, si = [], 0, 0, 0
    for k, nb, w in zip(t.bin_ks, t.bin_counts, t.bin_vals):
        rows_c = _chunk_rows(k, wt, t.chunk_slots)
        if sctx2 is None and -(-nb // rows_c) >= _SCAN_MIN_CHUNKS:
            # many-chunk bin: rolled lax.scan (see _SCAN_MIN_CHUNKS)
            def t_body(cols_c, wv, vl_c, x_c):
                seg = _gather_slots(pl2.table(), cols_c, p_w, wt)
                return (_slot_grads(seg, vl_c, x_c, wv, hf, fh, nh, slope),)

            cols_seg = jax.lax.slice_in_dim(t.flat_cols, off, off + nb * k)
            (o_b,) = _rolled_map(
                cols_seg, nb, k,
                (w, vl_t[r0 : r0 + nb], x_t[r0 : r0 + nb]), t_body, rows_c,
            )
            parts.append(o_b)
            off += nb * k
            r0 += nb
            si += 1
            continue
        outs = []
        for ci, (lo, hi) in enumerate(_chunks(nb, k, wt, t.chunk_slots)):
            cols = jax.lax.slice_in_dim(
                t.flat_cols, off + lo * k, off + hi * k
            ).reshape(hi - lo, k)
            seg = _gather_slots(pl2.table(), cols, p_w, wt,
                                sctx2[si][ci] if sctx2 else None)
            wv = jax.lax.slice_in_dim(w, lo, hi)
            o_c = _slot_grads(
                seg, vl_t[r0 + lo : r0 + hi], x_t[r0 + lo : r0 + hi], wv,
                hf, fh, nh, slope,
            )
            (o_c,) = pl2.step(o_c)
            outs.append(o_c)
        parts.append(jnp.concatenate(outs) if len(outs) > 1 else outs[0])
        off += nb * k
        r0 += nb
        si += 1
    if t.n_big:
        vb, kb = t.big_vals.shape
        acc = jnp.zeros((t.n_big, hf + nh), jnp.float32)
        rows_c = _chunk_rows(kb, wt, t.chunk_slots)
        if sctx2 is None and -(-vb // rows_c) >= _SCAN_MIN_CHUNKS:
            def t_hub_body(acc, cols_c, wv, vrow):
                seg = _gather_slots(pl2.table(), cols_c, p_w, wt)
                dgv = _slot_grads(
                    seg, vl_t[r0 + vrow], x_t[r0 + vrow], wv, hf, fh, nh,
                    slope,
                )
                return acc + jax.ops.segment_sum(
                    dgv, vrow, num_segments=t.n_big, indices_are_sorted=True
                )

            cols_seg = jax.lax.slice_in_dim(t.flat_cols, off, off + vb * kb)
            acc = _rolled_acc(
                cols_seg, vb, kb, (t.big_vals, t.big_vrow),
                acc, t_hub_body, rows_c,
            )
        else:
            for ci, (lo, hi) in enumerate(_chunks(vb, kb, wt, t.chunk_slots)):
                cols = jax.lax.slice_in_dim(
                    t.flat_cols, off + lo * kb, off + hi * kb
                ).reshape(hi - lo, kb)
                seg = _gather_slots(pl2.table(), cols, p_w, wt,
                                    sctx2[si][ci] if sctx2 else None)
                wv = jax.lax.slice_in_dim(t.big_vals, lo, hi)
                vrow = jax.lax.slice_in_dim(t.big_vrow, lo, hi)
                dgv = _slot_grads(
                    seg, vl_t[r0 + vrow], x_t[r0 + vrow], wv, hf, fh, nh,
                    slope,
                )
                acc = acc + jax.ops.segment_sum(
                    dgv, vrow, num_segments=t.n_big, indices_are_sorted=True
                )
                (acc,) = pl2.step(acc)
        parts.append(acc)
    dxx = _assemble(parts, t, c_pad, hf + nh, jnp.float32)
    return dxx[:, :hf], dxx[:, hf:], dvr


def _slot_grads(seg, vl_c, x_c, w, hf, fh, nh, slope):
    """Transpose-layout slot gradients for all heads.

    seg: (rows, k, hf+4H) gathered [dout | vr | m | s | sds] rows of
    each slot's destination r; vl_c: (rows, H) / x_c: (rows, hf) this
    t-row's (= source node c) values; w: (rows, k) slot mask.  Returns
    (rows, hf + H) = [dx per head | dvl per head]."""
    dx_h, dvl_h = [], []
    for h in range(nh):
        do = seg[..., h * fh : (h + 1) * fh]
        vr_g = seg[..., hf + h]
        m_g = seg[..., hf + nh + h]
        s_g = seg[..., hf + 2 * nh + h]
        sds_g = seg[..., hf + 3 * nh + h]
        zpre = vl_c[:, h : h + 1] + vr_g
        z = jnp.where(w != 0, _lrelu(zpre, slope), _NEG)
        p = jnp.where(w != 0, jnp.exp(z - m_g) / s_g, 0.0)
        dp = jnp.sum(do * x_c[:, None, h * fh : (h + 1) * fh], axis=-1)
        ds = p * (dp - sds_g)
        dz = ds * jnp.where(zpre > 0, 1.0, slope)
        dx_h.append(jnp.sum(p[..., None] * do, axis=1))
        dvl_h.append(jnp.sum(dz, axis=1, keepdims=True))
    dx = jnp.concatenate(dx_h, axis=1) if nh > 1 else dx_h[0]
    dvl = jnp.concatenate(dvl_h, axis=1) if nh > 1 else dvl_h[0]
    return jnp.concatenate([dx, dvl], axis=1)


def _attn_bwd_raw(ab: AttnBell, x, vl, vr, gth, probs, vr_bin, m_node, s_node,
                  slope, dout, c_pad):
    hf = x.shape[1]
    nh = vl.shape[1]
    fh = hf // nh
    b = ab.fwd

    dout_bin = dout if ab.rows is None else dout[ab.rows]

    # ---- pass 1 (forward layout, no gathers): dvr and the per-node
    # softmax-backward row sums sds[r,h] = sum_s p_s * dp_s ------------- #
    dvr_parts, sds_parts, off, r0, pi = [], [], 0, 0, 0
    for k, nb, w in zip(b.bin_ks, b.bin_counts, b.bin_vals):
        seg = jax.lax.slice_in_dim(gth, off, off + nb * k).reshape(nb, k, hf + nh)
        dvr_h, sds_h = [], []
        for h in range(nh):
            p = probs[pi][h]
            do = dout_bin[r0 : r0 + nb, h * fh : (h + 1) * fh].astype(jnp.float32)
            # multiply+reduce, NOT einsum: a (nb, k, f) x (nb, f) einsum
            # lowers to nb tiny batched matmuls
            dp = jnp.sum(
                seg[..., h * fh : (h + 1) * fh].astype(jnp.float32)
                * do[:, None, :],
                axis=-1,
            )
            sds = jnp.sum(p * dp, axis=1, keepdims=True)
            ds = p * (dp - sds)
            zpre = seg[..., hf + h].astype(jnp.float32) + vr_bin[
                r0 : r0 + nb, h : h + 1
            ].astype(jnp.float32)
            dz = ds * jnp.where(zpre > 0, 1.0, slope)
            dvr_h.append(jnp.sum(dz, axis=1, keepdims=True))
            sds_h.append(sds)
        dvr_parts.append(jnp.concatenate(dvr_h, axis=1) if nh > 1 else dvr_h[0])
        sds_parts.append(jnp.concatenate(sds_h, axis=1) if nh > 1 else sds_h[0])
        off += nb * k
        r0 += nb
        pi += 1
    if b.n_big:
        vb, kb = b.big_vals.shape
        seg = jax.lax.slice_in_dim(gth, off, off + vb * kb).reshape(vb, kb, hf + nh)
        dvr_h, sds_h = [], []
        for h in range(nh):
            p = probs[pi][h]
            do = dout_bin[r0 + b.big_vrow, h * fh : (h + 1) * fh].astype(jnp.float32)
            dp = jnp.sum(
                seg[..., h * fh : (h + 1) * fh].astype(jnp.float32)
                * do[:, None, :],
                axis=-1,
            )
            sds = jax.ops.segment_sum(
                jnp.sum(p * dp, axis=1), b.big_vrow,
                num_segments=b.n_big, indices_are_sorted=True,
            )[:, None]
            ds = p * (dp - sds[b.big_vrow][:, 0][:, None])
            zpre = seg[..., hf + h].astype(jnp.float32) + vr_bin[
                r0 + b.big_vrow, h
            ][:, None].astype(jnp.float32)
            dz = ds * jnp.where(zpre > 0, 1.0, slope)
            dvr_h.append(
                jax.ops.segment_sum(
                    jnp.sum(dz, axis=1, keepdims=True), b.big_vrow,
                    num_segments=b.n_big, indices_are_sorted=True,
                )
            )
            sds_h.append(sds)
        dvr_parts.append(jnp.concatenate(dvr_h, axis=1) if nh > 1 else dvr_h[0])
        sds_parts.append(jnp.concatenate(sds_h, axis=1) if nh > 1 else sds_h[0])
    n_pad = dout.shape[0]
    dvr = _assemble(dvr_parts, b, n_pad, nh, jnp.float32)
    sds_node = _assemble(sds_parts, b, n_pad, nh, jnp.float32)

    # ---- pass 2 (transpose layout): recompute p and dz per transpose
    # slot from node-sized tables, reduce densely --------------------- #
    t = ab.t
    w_tab = jnp.concatenate(
        [dout.astype(jnp.float32), vr.astype(jnp.float32),
         m_node, s_node, sds_node],
        axis=1,
    )                                                            # (n_pad, hf+4H)
    wt = hf + 4 * nh
    g2 = w_tab[t.flat_cols]                                      # (St, hf+4H) — hot
    vl_t = vl.astype(jnp.float32) if ab.t_rows is None else vl[ab.t_rows].astype(jnp.float32)
    x_t = x.astype(jnp.float32) if ab.t_rows is None else x[ab.t_rows].astype(jnp.float32)

    parts, off, r0 = [], 0, 0
    for k, nb, w in zip(t.bin_ks, t.bin_counts, t.bin_vals):
        seg = jax.lax.slice_in_dim(g2, off, off + nb * k).reshape(nb, k, wt)
        parts.append(
            _slot_grads(seg, vl_t[r0 : r0 + nb], x_t[r0 : r0 + nb], w,
                        hf, fh, nh, slope)
        )
        off += nb * k
        r0 += nb
    if t.n_big:
        vb, kb = t.big_vals.shape
        seg = jax.lax.slice_in_dim(g2, off, off + vb * kb).reshape(vb, kb, wt)
        rowsel = r0 + t.big_vrow
        dgv = _slot_grads(seg, vl_t[rowsel], x_t[rowsel], t.big_vals,
                          hf, fh, nh, slope)
        parts.append(
            jax.ops.segment_sum(
                dgv, t.big_vrow, num_segments=t.n_big, indices_are_sorted=True
            )
        )
    dxx = _assemble(parts, t, c_pad, hf + nh, jnp.float32)
    return dxx[:, :hf], dxx[:, hf:], dvr


def _is_flat(ab: AttnBell, hf: int, nh: int) -> bool:
    """True when the whole slot table fits the gather-buffer budget (the
    fast path: one flat gather, probabilities saved as residuals).
    Layouts carrying stage tables always take the chunked path — their
    node table is over the gather cliff, and only the chunked gathers
    can ride the staged dedup tables.  A schedule-driven chunk_slots
    (DIR col_tile) also forces the chunked path: the directive exists to
    change the executed tiling."""
    if ab.fwd.stage is not None or ab.t.stage is not None:
        return False
    if ab.fwd.chunk_slots or ab.t.chunk_slots:
        return False
    s_f = int(ab.fwd.flat_cols.shape[0]) * _phys_cols(hf + nh)
    s_t = int(ab.t.flat_cols.shape[0]) * _phys_cols(hf + 4 * nh)
    return max(s_f, s_t) <= _ATTN_FLAT_ELEMS


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def attention_aggregate(n_pad, c_pad, slope, ab: AttnBell, x, vl, vr):
    """out = softmax-attention aggregation (H heads in one gather).

    Head h: score(e: c->r) = leaky_relu(vl[c,h] + vr[r,h]);
    per-destination softmax; out[r, h*fh:(h+1)*fh] = sum_c p_h(e) *
    x[c, h*fh:(h+1)*fh].  vl: (c_pad, H), vr: (n_pad, H),
    x: (c_pad, H*fh); H is inferred from vl (H=1 is the DSL GAT)."""
    if _is_flat(ab, x.shape[1], vl.shape[1]):
        out, *_ = _attn_fwd_raw(ab, x, vl, vr, slope, n_pad)
    else:
        # primal = inference: no backward will read the flash residuals,
        # so skip their accumulation (it doubles the per-slot reduce)
        out, *_ = _attn_fwd_chunked(ab, x, vl, vr, slope, n_pad,
                                    need_flash=False)
    return out


def _attn_fwd(n_pad, c_pad, slope, ab, x, vl, vr):
    if _is_flat(ab, x.shape[1], vl.shape[1]):
        out, gth, probs, vr_bin, m_node, s_node = _attn_fwd_raw(
            ab, x, vl, vr, slope, n_pad
        )
        return out, (ab, x, vl, vr, gth, probs, vr_bin, m_node, s_node)
    out, _, _, _, m_node, s_node, flash = _attn_fwd_chunked(
        ab, x, vl, vr, slope, n_pad
    )
    # the probs slot carries the flash-identity residuals on the chunked
    # path (out32, outpos, spos)
    return out, (ab, x, vl, vr, None, flash, None, m_node, s_node)


def _attn_bwd(n_pad, c_pad, slope, res, dout):
    ab, x, vl, vr, gth, probs, vr_bin, m_node, s_node = res
    if gth is None:
        dx, dvl, dvr = _attn_bwd_chunked(
            ab, x, vl, vr, m_node, s_node, slope, dout, c_pad, flash=probs,
        )
    else:
        dx, dvl, dvr = _attn_bwd_raw(
            ab, x, vl, vr, gth, probs, vr_bin, m_node, s_node, slope, dout, c_pad
        )

    def zct(b):
        return dataclasses.replace(
            b,
            flat_cols=_float0_like(b.flat_cols),
            bin_vals=tuple(jnp.zeros_like(v) for v in b.bin_vals),
            big_vals=jnp.zeros_like(b.big_vals) if b.big_vals is not None else None,
            big_vrow=_float0_like(b.big_vrow) if b.big_vrow is not None else None,
            diag=jnp.zeros_like(b.diag) if b.diag is not None else None,
            out_index=_float0_like(b.out_index) if b.out_index is not None else None,
            stage=tuple(
                (_float0_like(u), _float0_like(l)) for u, l in b.stage
            ) if b.stage is not None else None,
        )

    dab = AttnBell(
        fwd=zct(ab.fwd),
        t=zct(ab.t),
        rows=_float0_like(ab.rows) if ab.rows is not None else None,
        t_rows=_float0_like(ab.t_rows) if ab.t_rows is not None else None,
    )
    return (dab, dx.astype(x.dtype), dvl.astype(vl.dtype), dvr.astype(vr.dtype))


attention_aggregate.defvjp(_attn_fwd, _attn_bwd)
