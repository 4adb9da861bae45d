"""Sparse-dense matrix multiplication (node aggregation).

JAX replacement for the reference's generated CUDA SpMM kernels
(`aggregate_node_mul_sum_coarseN_kernel*`, reference: src/codegen/cuda.h:282-436)
and its cuSPARSE fallback (reference: src/codegen/cuda.h:211-279), together
with their `torch::autograd::Function` wrappers that run the backward pass
on the transpose graph (reference: src/codegen/common.h:630-1084).

Semantics:  out[d] = sum over edges e with dst[e]==d of vals[e] * x[src[e]]

Three strategies (selected per graph in gala_tpu.ops.graph.choose_strategy):

- dense:        A @ x as one matmul.  The adjacency is densified once
                (structural vals) or re-scattered per call (learned edge
                values).  For small graphs this is the speed-of-light path.
- segment:      weighted gather then `segment_sum` over dst-sorted edges.
- segment_scan: the same, chunked with `lax.scan` + scatter-add into an
                (N, F) accumulator, bounding the (E, F) intermediate — the
                analog of the reference's ordered column tiling
                (reference: src/ops/tiling.h:222-284).

Backward: dx = SpMM(A^T, dZ) uses the pre-sorted transpose edge list
(`t_src/t_dst`), never an unsorted scatter; when edge values are learned
(GAT), dvals = SDDMM(dZ, X) computed gather-only in forward edge order —
the same split as the reference's backward kernels
(reference: src/codegen/cuda.h:658-760 node_spmv_backward_of_sddmm_*).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.ops.graph import Graph

# edges processed per scan chunk in the segment_scan strategy
SCAN_CHUNK = 1 << 17


def _float0_like(x):
    return np.zeros(x.shape, jax.dtypes.float0)


# --------------------------------------------------------------------------- #
# raw segment kernels (no autodiff)
# --------------------------------------------------------------------------- #
def _seg_oneshot(src, dst, vals, x, n_out):
    msg = vals.astype(x.dtype)[:, None] * x[src]
    return jax.ops.segment_sum(msg, dst, num_segments=n_out, indices_are_sorted=True)


def sddmm_edges(src, dst, a, b):
    """Per-edge dot product <a[src[e]], b[dst[e]]>, memory-bounded: above
    the gathered-buffer budget the edges run a rolled lax.scan with two
    bounded (rows, F) gather temps instead of two (E, F) buffers (63GB
    at ogbn-products full scale).  Shared by ops.edge.sddmm and the
    edge-value SpMM backwards."""
    e = src.shape[0]
    f = a.shape[1]
    rows = max(_BELL_CHUNK_ELEMS // max(2 * _phys_cols(f), 1), 1)
    n_chunks = -(-e // rows)
    if n_chunks <= 1:
        return jnp.sum(a[src] * b[dst], axis=-1)
    pad = n_chunks * rows - e
    if pad:
        src = jnp.concatenate([src, jnp.zeros((pad,), src.dtype)])
        dst = jnp.concatenate([dst, jnp.zeros((pad,), dst.dtype)])

    def body(_, chunk):
        s_c, d_c = chunk
        return 0, jnp.sum(a[s_c] * b[d_c], axis=-1)

    _, out = jax.lax.scan(
        body, 0, (src.reshape(n_chunks, rows), dst.reshape(n_chunks, rows))
    )
    return out.reshape(-1)[:e]


def _seg_scan(src, dst, vals, x, n_out, chunk: int = 0):
    """Chunked scatter-add aggregation.  `chunk` is the edges-per-chunk
    granularity (0 = module default SCAN_CHUNK); the DIR `col_tile`
    directive drives it through Graph.scan_chunk (reference ordered
    column tiling: src/ops/tiling.h:222-284).  Edges are zero-padded up
    to an exact multiple so the directive always chunks — never a
    silent one-shot fallback."""
    e = src.shape[0]
    chunk = min(chunk or SCAN_CHUNK, e)
    n_chunks = -(-e // chunk)
    pad = n_chunks * chunk - e
    if pad:
        # dst stays sorted (pad rows target the last padded row) and
        # vals=0 keeps padding numerically inert
        src = jnp.concatenate([src, jnp.zeros(pad, src.dtype)])
        dst = jnp.concatenate([dst, jnp.full(pad, n_out - 1, dst.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros(pad, vals.dtype)])
    srcs = src.reshape(n_chunks, chunk)
    dsts = dst.reshape(n_chunks, chunk)
    valss = vals.reshape(n_chunks, chunk)

    def body(acc, sdv):
        s, d, v = sdv
        msg = v.astype(x.dtype)[:, None] * x[s]
        acc = acc.at[d].add(msg, indices_are_sorted=True, unique_indices=False)
        return acc, None

    acc0 = jnp.zeros((n_out, x.shape[1]), x.dtype)
    acc, _ = jax.lax.scan(body, acc0, (srcs, dsts, valss))
    return acc


def _seg_dispatch(src, dst, vals, x, n_out, scan: int):
    """scan == 0: one-shot segment_sum; scan > 0: chunked scatter-add
    with `scan` edges per chunk."""
    if scan:
        return _seg_scan(src, dst, vals, x, n_out, scan)
    return _seg_oneshot(src, dst, vals, x, n_out)


# --------------------------------------------------------------------------- #
# row-split ELL kernels (see gala_tpu.data.ell for the layout + rationale)
# --------------------------------------------------------------------------- #
def slot_reduce(w, seg, out_dtype):
    """out[v] = sum_k w[v, k] * seg[v, k, :], accumulated in f32.

    On a GPU, a multiply and a reduce over the slot axis.  XLA:GPU would
    lower the batched (v,k),(v,k,f) einsum to one matmul per bin shape
    and autotune each while compiling, for a product a matmul unit
    cannot speed up (one k-long dot per row).  Cold on an H100, the
    card-only tests ran in 345 s this way and had not finished after
    600 s with the einsum.  On the CPU, which autotunes
    nothing, the einsum stays: the CPU tests that compare two summation
    orders were set against its rounding."""
    if jax.default_backend() == "gpu":
        prod = w.astype(jnp.float32)[..., None] * seg.astype(jnp.float32)
        return jnp.sum(prod, axis=1).astype(out_dtype)
    return jnp.einsum(
        "vk,vkf->vf", w, seg, preferred_element_type=jnp.float32
    ).astype(out_dtype)


def _ell_raw(cols, vals, vrow, x, n_out):
    """partial[v] = sum_k vals[v,k] * x[cols[v,k]]; scatter V rows only.

    Gathers happen at x's dtype (bf16 features double the row-gather
    rate); the K-reduction accumulates in f32.  Above the gathered-
    buffer budget (physical elements, see _BELL_CHUNK_ELEMS) the rows
    are processed by a rolled lax.scan that scatter-adds each chunk into
    the output carry — one bounded gather temp instead of a (V, K, F)
    buffer that OOMs at ogbn-products scale on the weighted/
    sparse-rewrite path."""
    v, k = cols.shape
    f = x.shape[1]
    rows = max(_BELL_CHUNK_ELEMS // max(k * _phys_cols(f), 1), 1)
    n_chunks = -(-v // rows)
    if n_chunks <= 1:
        gathered = x[cols]                               # (V, K, F) gather
        partial = slot_reduce(vals.astype(x.dtype), gathered, x.dtype)
        return jax.ops.segment_sum(
            partial, vrow, num_segments=n_out, indices_are_sorted=True
        )
    pad = n_chunks * rows - v
    if pad:
        cols = jnp.concatenate([cols, jnp.zeros((pad, k), cols.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad, k), vals.dtype)])
        # padded rows scatter zeros into the last real segment
        vrow = jnp.concatenate(
            [vrow, jnp.full((pad,), n_out - 1, vrow.dtype)]
        )

    def body(acc, chunk):
        cols_c, vals_c, vrow_c = chunk
        partial = slot_reduce(vals_c.astype(x.dtype), x[cols_c], x.dtype)
        return acc.at[vrow_c].add(partial), 0

    acc0 = jnp.zeros((n_out, f), x.dtype)
    acc, _ = jax.lax.scan(
        body, acc0,
        (cols.reshape(n_chunks, rows, k), vals.reshape(n_chunks, rows, k),
         vrow.reshape(n_chunks, rows)),
    )
    return acc


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _spmm_ell(n_out, c_out, cols, vals, vrow, t_cols, t_vals, t_vrow, x):
    return _ell_raw(cols, vals, vrow, x, n_out)


def _spmm_ell_fwd(n_out, c_out, cols, vals, vrow, t_cols, t_vals, t_vrow, x):
    out = _ell_raw(cols, vals, vrow, x, n_out)
    # forward-side arrays ride the residuals ONLY to shape their zero
    # cotangents: the two ELL layouts inflate differently (V != V_t on
    # degree-asymmetric graphs, e.g. Products), so transpose-side zeros
    # would be the wrong shape.  No memory cost — they alias the Graph's
    # live buffers.
    return out, (cols, vals, vrow, t_cols, t_vals, t_vrow)


def _spmm_ell_bwd(n_out, c_out, res, dz):
    cols, vals, vrow, t_cols, t_vals, t_vrow = res
    dx = _ell_raw(t_cols, t_vals, t_vrow, dz, c_out)
    return (
        _float0_like(cols), jnp.zeros_like(vals), _float0_like(vrow),
        _float0_like(t_cols), jnp.zeros_like(t_vals), _float0_like(t_vrow),
        dx,
    )


_spmm_ell.defvjp(_spmm_ell_fwd, _spmm_ell_bwd)


def _ev_slots(evals, perm, mask):
    """Scatter per-edge values into ELL slots (padding slots -> 0)."""
    return evals[perm] * mask


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _spmm_ev_ell(
    n_out, c_out,
    cols, vrow, perm, mask,
    t_cols, t_vrow, t_perm, t_mask,
    src, dst, evals, x,
):
    return _ell_raw(cols, _ev_slots(evals, perm, mask), vrow, x, n_out)


def _spmm_ev_ell_fwd(
    n_out, c_out,
    cols, vrow, perm, mask,
    t_cols, t_vrow, t_perm, t_mask,
    src, dst, evals, x,
):
    out = _ell_raw(cols, _ev_slots(evals, perm, mask), vrow, x, n_out)
    # forward-side layout arrays in the residuals shape their zero
    # cotangents (V != V_t on degree-asymmetric graphs — see _spmm_ell)
    return out, (cols, vrow, perm, mask,
                 t_cols, t_vrow, t_perm, t_mask, src, dst, evals, x)


def _spmm_ev_ell_bwd(n_out, c_out, res, dz):
    (cols, vrow, perm, mask,
     t_cols, t_vrow, t_perm, t_mask, src, dst, evals, x) = res
    dx = _ell_raw(t_cols, _ev_slots(evals, t_perm, t_mask), t_vrow, dz, c_out)
    devals = sddmm_edges(src, dst, x, dz)
    z = _float0_like
    return (
        z(cols), z(vrow), z(perm), jnp.zeros_like(mask),
        z(t_cols), z(t_vrow), z(t_perm), jnp.zeros_like(t_mask),
        z(src), z(dst), devals, dx,
    )


_spmm_ev_ell.defvjp(_spmm_ev_ell_fwd, _spmm_ev_ell_bwd)


# --------------------------------------------------------------------------- #
# binned ELL (strategy 'bell'): scatter-free degree-class SpMM
# --------------------------------------------------------------------------- #
# elements budget for one gathered (rows, k, F) intermediate: keeps live
# buffers bounded on big graphs (a single flat (S, F) gather materializes
# gigabytes at ogbn-products scale).  Budgets count columns padded to 128
# lanes (_phys_cols); they are inherited constants, not yet measured on
# the GPU.
_BELL_CHUNK_ELEMS = 1 << 26
_BELL_FLAT_ELEMS = 1 << 29
# at/above this many chunks the unrolled barrier chain is replaced by a
# rolled lax.scan (HLO size / compile time dominates the lost depth-2
# pipeline overlap there)
_SCAN_MIN_CHUNKS = 16

# Gather-table packing: on the hardware this was first tuned for, the
# XLA row-gather rate fell sharply once the table's footprint with its
# minor dim padded to 128 lanes crossed ~100 MB (a "gather cliff").  For narrow features (f <= 64) the
# padding wastes most of each row, so packing P = 128//f nodes per
# physical row shrinks the table P-fold — same bytes per gathered row,
# P-fold smaller working set — and a (v,k,P)-expanded weight reduce
# selects each slot's lane window in one streaming pass.  The threshold
# is inherited and not yet measured on the GPU;
# scripts/bench_packed_gather.py measures the crossover.
_PACK_MIN_BYTES = int(__import__("os").environ.get(
    "GALA_PACK_MIN_BYTES", str(96 << 20)
))

# Staged (two-level) gather: once the padded table crosses the gather
# cliff and node-packing cannot apply (f > 64), gather each canonical
# chunk's UNIQUE rows from the big table (few rows) into a small staged
# table and distribute to slots with a small-table gather.  It loses at
# high unique fractions (the layout builder skips the tables there);
# scripts/bench_staged_gather.py measures it.  The thresholds are
# inherited and not yet measured on the GPU.  The lax.optimization_barrier around the staged
# table is what keeps XLA from folding the two gathers back into one
# big-table gather.
_STAGE_MIN_BYTES = 96 << 20
_STAGE_MAX_PHYS = 256   # canonical chunks at f_phys 256 = 268MB buffers


def _phys_cols(f: int) -> int:
    return ((f + 127) // 128) * 128


def _pack_factor(n_rows: int, f: int, itemsize: int) -> int:
    if n_rows * _phys_cols(f) * itemsize <= _PACK_MIN_BYTES:
        return 1
    return max(min(128 // max(f, 1), 8), 1)


def _pack_table(x, p):
    """(n, f) -> (ceil(n/p), p*f), row j holds nodes j*p .. j*p+p-1."""
    n, f = x.shape
    n_pad = -(-n // p) * p
    if n_pad != n:
        x = jnp.concatenate([x, jnp.zeros((n_pad - n, f), x.dtype)], axis=0)
    return x.reshape(n_pad // p, p * f)


def _packed_chunk_reduce(cols_c, vals_c, xt, p, f, out_dtype):
    """One chunk of the packed-table reduce.  Every operand stays 2-D
    (or the proven (v,k,f) dot shape): 3-D small-minor-dim operands
    can tile-pad up to 64x and OOM at bin scale.

    cols_c: (rows, k) UNPACKED node ids; xt: packed (n/p, p*f) table."""
    rows, k = cols_c.shape
    flat = cols_c.reshape(-1)
    seg2 = xt[flat // p]                       # (rows*k, p*f) 2-D gather
    lane = (flat % p)[:, None]                 # (rows*k, 1)
    acc = jnp.zeros((rows * k, f), xt.dtype)
    for c in range(p):
        acc = acc + jnp.where(
            lane == c, jax.lax.slice_in_dim(seg2, c * f, (c + 1) * f, axis=1), 0
        )
    return slot_reduce(vals_c.astype(xt.dtype), acc.reshape(rows, k, f), out_dtype)


def _bell_bin_reduce(cols_flat, vals, x, out_dtype, k, p=1, f=None, stage=None,
                     chunk_slots=0):
    """sum_k vals[v,k] * x[cols[v,k]] with the gather chunked to a
    bounded intermediate; per-chunk gathers fuse into their reduce.

    cols_flat is the bin's 1-D slot-id slice — the (nb, k) view is taken
    PER CHUNK only: a bin-level 2-D reshape of a huge-nb/small-k index
    array can materialize 128-lane padded (64x, 79 GB at papers100M
    scale).  When p > 1, `x` is a packed (n/p, p*f) table and cols hold
    UNPACKED node ids (// and % happen per chunk).  When `stage` is
    given (list of per-chunk (uniq, local) dedup tables on the canonical
    S_CHUNK boundaries) the gather runs two-level: uniq rows from the
    big table, slots from the barrier-staged small table."""
    nb = vals.shape[0]
    f = x.shape[1] if f is None else f
    if stage is not None:
        from gala_tpu.data.ell import stage_chunks

        bounds = stage_chunks(k, nb, chunk_slots)
        assert len(bounds) == len(stage), (len(bounds), len(stage))
        if len(bounds) >= _SCAN_MIN_CHUNKS:
            # Many chunks: rolled lax.scan, mirroring the unstaged path
            # below.  The unrolled barrier chain does NOT bound liveness
            # once the reduce sits inside a training while-loop: XLA's
            # remat/compression scheduling kept every chunk's staged
            # gather temp live at once (the whole (S, f) slot-feature
            # array at Products-0.25 scale).  A scan body
            # is its own memory barrier: one chunk's st/seg is live at a
            # time.  Ragged arrays are padded to uniform shapes host-
            # side cheap: uniq to the segment max (extra rows gather
            # redundantly, <=12.5% by the %8 pad + chunk evenness),
            # last chunk's local/vals with zeros (zero vals null the
            # garbage gathers).
            rows = bounds[0][1] - bounds[0][0]
            u_max = max(int(u.shape[0]) for u, _ in stage)
            uniq_s = jnp.stack([
                jnp.pad(u, (0, u_max - u.shape[0])) for u, _ in stage
            ])
            local_s = jnp.stack([
                jnp.pad(l, (0, rows * k - l.shape[0])) for _, l in stage
            ])
            nb_pad = len(bounds) * rows
            vals_s = vals
            if nb_pad != nb:
                vals_s = jnp.concatenate(
                    [vals, jnp.zeros((nb_pad - nb, k), vals.dtype)]
                )
            vals_s = vals_s.reshape(len(bounds), rows, k)

            # Software-pipelined scan: the carry holds chunk i's staged
            # table while the body gathers chunk i+1's — the stage-1
            # uniq gather overlaps the stage-2 distribute + reduce of
            # the previous chunk (the depth-2 overlap the unrolled
            # barrier chain had; a plain scan serializes the two-level
            # gather).  uniq rolls by
            # one so iteration i carries uniq[i+1]; the final roll-around
            # gather of uniq[0] is dead work, one chunk in C.
            def body(st, chunk):
                uniq_next, local_c, vals_c = chunk
                seg = st[local_c.reshape(rows, k)]
                o_c = slot_reduce(vals_c.astype(x.dtype), seg, out_dtype)
                st_next = jax.lax.optimization_barrier(x[uniq_next])
                return st_next, o_c

            st0 = jax.lax.optimization_barrier(x[uniq_s[0]])
            _, outs = jax.lax.scan(
                body, st0, (jnp.roll(uniq_s, -1, axis=0), local_s, vals_s)
            )
            return outs.reshape(nb_pad, -1)[:nb]
        outs = []
        tabs = [x, x]
        for c, (lo, hi) in enumerate(bounds):
            uniq, local = stage[c]
            tab = tabs[c % 2]
            st = jax.lax.optimization_barrier(tab[uniq])
            seg = st[local.reshape(hi - lo, k)]
            vals_c = jax.lax.slice_in_dim(vals, lo, hi)
            o_c = slot_reduce(vals_c.astype(x.dtype), seg, out_dtype)
            tabs[c % 2], o_c = jax.lax.optimization_barrier((tab, o_c))
            outs.append(o_c)
        return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    if chunk_slots:
        # schedule-driven ordered column tile (DIR col_tile): the
        # directive's slot granularity wins over the memory budget
        rows_per_chunk = max(chunk_slots // k, 1)
    else:
        rows_per_chunk = max(_BELL_CHUNK_ELEMS // max(k * _phys_cols(f * p), 1), 1)
    n_chunks = max(-(-nb // rows_per_chunk), 1)

    def chunk_reduce(tab, cols_c, vals_c):
        if p > 1:
            return _packed_chunk_reduce(cols_c, vals_c, tab, p, f, out_dtype)
        seg = tab[cols_c]
        return slot_reduce(vals_c.astype(x.dtype), seg, out_dtype)

    if n_chunks == 1:
        return chunk_reduce(x, cols_flat.reshape(nb, k), vals)
    if n_chunks >= _SCAN_MIN_CHUNKS:
        # Many chunks: a rolled lax.scan instead of the unrolled barrier
        # chain.  One chunk's gather temp is live at a time (the scan
        # body is its own memory barrier), the HLO stays O(1) in chunk
        # count (unrolled many-chunk programs cost minutes of compile at
        # papers100M scale), at the price of the depth-2 adjacent-chunk
        # overlap (the rolled form only triggers where compile/HLO size
        # dominates).
        nb_pad = n_chunks * rows_per_chunk
        cols2 = cols_flat
        vals2 = vals
        if nb_pad != nb:
            cols2 = jnp.concatenate(
                [cols2, jnp.zeros((nb_pad - nb) * k, cols2.dtype)]
            )
            vals2 = jnp.concatenate(
                [vals2, jnp.zeros((nb_pad - nb, k), vals2.dtype)]
            )
        cols2 = cols2.reshape(n_chunks, rows_per_chunk, k)
        vals2 = vals2.reshape(n_chunks, rows_per_chunk, k)

        def body(_, chunk):
            cols_c, vals_c = chunk
            return 0, chunk_reduce(x, cols_c, vals_c)

        _, outs = jax.lax.scan(body, 0, (cols2, vals2))
        return outs.reshape(nb_pad, -1)[:nb]
    outs = []
    # Two alternating barrier-chained table refs: chunk i+2's gather
    # waits on chunk i's output, so at most ~2 chunk buffers are live
    # (without barriers XLA holds EVERY chunk's gather temp at once and
    # OOMs) while gather/compute of adjacent chunks still pipeline.
    tabs = [x, x]
    for c in range(n_chunks):
        lo = c * rows_per_chunk
        hi = min(nb, lo + rows_per_chunk)
        tab = tabs[c % 2]
        cols_c = jax.lax.slice_in_dim(cols_flat, lo * k, hi * k).reshape(hi - lo, k)
        vals_c = jax.lax.slice_in_dim(vals, lo, hi)
        o_c = chunk_reduce(tab, cols_c, vals_c)
        tabs[c % 2], o_c = jax.lax.optimization_barrier((tab, o_c))
        outs.append(o_c)
    return jnp.concatenate(outs, axis=0)


def _split_stage(bell):
    """Split the flat (uniq, local) chunk-pair tuple into per-segment
    lists following the canonical chunk counts (data.ell.stage_chunks)."""
    from gala_tpu.data.ell import stage_chunks

    seg_shapes = [(k, nb) for k, nb in zip(bell.bin_ks, bell.bin_counts)]
    if bell.n_big:
        seg_shapes.append((bell.big_vals.shape[1], bell.big_vals.shape[0]))
    out, i = [], 0
    for k, nb in seg_shapes:
        n_chunks = len(stage_chunks(k, nb, bell.chunk_slots))
        out.append(list(bell.stage[i : i + n_chunks]))
        i += n_chunks
    assert i == len(bell.stage), (i, len(bell.stage))
    return out


def _bell_raw(bell, x, n_out_pad):
    """Per-degree-class gathers + dense reductions + hub segment-sum
    (see gala_tpu.data.ell.build_binned_ell).  Output is in global node
    order, padded to n_out_pad rows."""
    f = x.shape[1]
    s_total = bell.flat_cols.shape[0]
    itemsize = jnp.dtype(x.dtype).itemsize
    p = _pack_factor(x.shape[0], f, itemsize)
    xt = _pack_table(x, p) if p > 1 else x
    # staged two-level gather: only for big unpackable tables (f > 64)
    # with enough per-chunk duplication to win (see _STAGE_MIN_BYTES)
    tab_bytes = x.shape[0] * _phys_cols(f) * itemsize
    use_stage = (
        bell.stage is not None and p == 1
        and tab_bytes > _STAGE_MIN_BYTES
        and _phys_cols(f) <= _STAGE_MAX_PHYS
    )
    stage_by_seg = _split_stage(bell) if use_stage else None
    # one flat gather when the (S, F) intermediate fits the budget
    # (fastest); per-bin chunked gathers otherwise (bounded memory).
    # Packed mode always goes through the chunked reducer (its per-chunk
    # //p and %p keep every index intermediate chunk-sized).
    flat = (
        p == 1 and not use_stage and not bell.chunk_slots
        and s_total * _phys_cols(f) <= _BELL_FLAT_ELEMS
    )
    gathered = x[bell.flat_cols] if flat else None

    def bin_reduce(off, nb, k, vals, seg_idx):
        if flat:
            seg = jax.lax.slice_in_dim(gathered, off, off + nb * k).reshape(nb, k, f)
            return slot_reduce(vals.astype(x.dtype), seg, x.dtype)
        cols_flat = jax.lax.slice_in_dim(bell.flat_cols, off, off + nb * k)
        return _bell_bin_reduce(
            cols_flat, vals, xt, x.dtype, k, p=p, f=f,
            stage=stage_by_seg[seg_idx] if use_stage else None,
            chunk_slots=bell.chunk_slots,
        )

    parts = []
    off = 0
    seg_idx = 0
    for k, nb, vals in zip(bell.bin_ks, bell.bin_counts, bell.bin_vals):
        parts.append(bin_reduce(off, nb, k, vals, seg_idx))
        off += nb * k
        seg_idx += 1
    if bell.n_big:
        vb, kb = bell.big_vals.shape
        partial = bin_reduce(off, vb, kb, bell.big_vals, seg_idx)
        parts.append(
            jax.ops.segment_sum(
                partial, bell.big_vrow,
                num_segments=bell.n_big, indices_are_sorted=True,
            )
        )
    out = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    if bell.out_index is not None:
        # bin order -> global order; padding rows read the appended 0 row
        out = jnp.concatenate([out, jnp.zeros((1, f), x.dtype)], axis=0)
        out = out[bell.out_index]
    else:
        pad = n_out_pad - out.shape[0]
        if pad > 0:
            out = jnp.concatenate([out, jnp.zeros((pad, f), x.dtype)], axis=0)
    if bell.diag is not None:
        out = out + bell.diag.astype(x.dtype) * x
    return out


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _spmm_bell(n_out, c_out, bell, t_bell, x):
    return _bell_raw(bell, x, n_out)


def _spmm_bell_fwd(n_out, c_out, bell, t_bell, x):
    return _bell_raw(bell, x, n_out), (bell, t_bell)


def _bell_zeros_ct(b):
    """Zero/float0 cotangent for a BellDev (layouts are wiring, not data)."""
    import dataclasses as _dc

    return _dc.replace(
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


def _spmm_bell_bwd(n_out, c_out, res, dz):
    bell, t_bell = res
    dx = _bell_raw(t_bell, dz, c_out)
    return (_bell_zeros_ct(bell), _bell_zeros_ct(t_bell), dx)


_spmm_bell.defvjp(_spmm_bell_fwd, _spmm_bell_bwd)


# --------------------------------------------------------------------------- #
# bell SpMM with LEARNED edge values (runtime slot values)
# --------------------------------------------------------------------------- #
def _with_slot_vals(bell, slot_flat):
    """A BellDev whose bin/big values come from a runtime (traced) flat
    slot vector — bin_vals are pytree children, so every _bell_raw code
    path (flat / chunked / rolled-scan) works unchanged with learned
    edge values."""
    import dataclasses as _dc

    bvs, off = [], 0
    for k, nb in zip(bell.bin_ks, bell.bin_counts):
        bvs.append(
            jax.lax.slice_in_dim(slot_flat, off, off + nb * k).reshape(nb, k)
        )
        off += nb * k
    big = None
    if bell.n_big:
        vb, kb = bell.big_vals.shape
        big = jax.lax.slice_in_dim(slot_flat, off, off + vb * kb).reshape(vb, kb)
    return _dc.replace(bell, bin_vals=tuple(bvs), big_vals=big)


def _bell_slot_grads(bell, x, dz_bin):
    """Per-slot gradients sum_f x[col_s] * dz[row_s] (the SDDMM sweep of
    the edge-value backward), flat (s_total,) in slot order.

    Rows above the gathered-buffer budget process in chunks so the
    (rows, k, f) float32 gather temp stays bounded — the same budget
    the forward's chunked reducer uses (_BELL_CHUNK_ELEMS)."""
    f = x.shape[1]

    def seg_grads(off, rows, k, dz_rows):
        rows_c = max(_BELL_CHUNK_ELEMS // max(k * _phys_cols(f), 1), 1)
        n_chunks = -(-rows // rows_c)
        if n_chunks >= _SCAN_MIN_CHUNKS:
            # rolled scan: one chunk's (rows_c, k, f) gather temp live
            # at a time (unrolled chains stop bounding liveness inside
            # a training while-loop — see _bell_bin_reduce)
            rows_pad = n_chunks * rows_c
            cols2 = jax.lax.slice_in_dim(
                bell.flat_cols, off, off + rows * k
            )
            dz2 = dz_rows
            if rows_pad != rows:
                cols2 = jnp.concatenate(
                    [cols2, jnp.zeros((rows_pad - rows) * k, cols2.dtype)]
                )
                dz2 = jnp.concatenate(
                    [dz2, jnp.zeros((rows_pad - rows, f), dz2.dtype)]
                )
            cols2 = cols2.reshape(n_chunks, rows_c, k)
            dz2 = dz2.reshape(n_chunks, rows_c, f)

            def body(_, chunk):
                cols_c, dz_c = chunk
                seg = x[cols_c].astype(jnp.float32)
                return 0, jnp.sum(
                    seg * dz_c.astype(jnp.float32)[:, None, :], axis=-1
                ).reshape(-1)

            _, outs = jax.lax.scan(body, 0, (cols2, dz2))
            return outs.reshape(-1)[: rows * k]
        outs = []
        for lo in range(0, rows, rows_c):
            hi = min(rows, lo + rows_c)
            cols = jax.lax.slice_in_dim(
                bell.flat_cols, off + lo * k, off + hi * k
            ).reshape(hi - lo, k)
            seg = x[cols].astype(jnp.float32)
            dzc = jax.lax.slice_in_dim(dz_rows, lo, hi).astype(jnp.float32)
            # multiply+reduce, not a batched-contraction einsum
            # (which lowers to tiny batched matmuls)
            outs.append(jnp.sum(seg * dzc[:, None, :], axis=-1).reshape(-1))
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    parts, off, r0 = [], 0, 0
    for k, nb in zip(bell.bin_ks, bell.bin_counts):
        dzc = jax.lax.slice_in_dim(dz_bin, r0, r0 + nb)
        parts.append(seg_grads(off, nb, k, dzc))
        off += nb * k
        r0 += nb
    if bell.n_big:
        vb, kb = bell.big_vals.shape
        dzc = jax.lax.slice_in_dim(dz_bin, r0, r0 + bell.n_big)[bell.big_vrow]
        parts.append(seg_grads(off, vb, kb, dzc))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _spmm_ev_bell(n_out, c_out, bell, t_bell, rows, edge_perm, t_edge_perm,
                  slot_of_edge, evals, x):
    """Bell SpMM with learned edge values, scatter-free in BOTH
    directions: slot values gather from evals via edge_perm; dx runs the
    transpose layout with the same values (t_edge_perm); d_evals gathers
    the per-slot SDDMM grads back through slot_of_edge.  Padded slots
    read evals' appended zero; padded edges read the appended zero
    slot."""
    slot_vals = jnp.concatenate(
        [evals, jnp.zeros(1, evals.dtype)]
    )[edge_perm]
    return _bell_raw(_with_slot_vals(bell, slot_vals), x, n_out)


def _spmm_ev_bell_fwd(n_out, c_out, bell, t_bell, rows, edge_perm,
                      t_edge_perm, slot_of_edge, evals, x):
    return (
        _spmm_ev_bell(n_out, c_out, bell, t_bell, rows, edge_perm,
                      t_edge_perm, slot_of_edge, evals, x),
        (bell, t_bell, rows, edge_perm, t_edge_perm, slot_of_edge, evals, x),
    )


def _spmm_ev_bell_bwd(n_out, c_out, res, dz):
    bell, t_bell, rows, edge_perm, t_edge_perm, slot_of_edge, evals, x = res
    evals_pad = jnp.concatenate([evals, jnp.zeros(1, evals.dtype)])
    dx = _bell_raw(
        _with_slot_vals(t_bell, evals_pad[t_edge_perm]), dz, c_out
    )
    # SDDMM sweep: dz rows in bin order (fake/pad row ids clamp to dz's
    # zero row n_out-1), per-slot grads, gathered back per edge
    dz_bin = dz[rows]
    dslot = _bell_slot_grads(bell, x, dz_bin)
    devals = jnp.concatenate(
        [dslot, jnp.zeros(1, dslot.dtype)]
    )[slot_of_edge].astype(evals.dtype)
    return (
        _bell_zeros_ct(bell),
        _bell_zeros_ct(t_bell),
        _float0_like(rows),
        _float0_like(edge_perm),
        _float0_like(t_edge_perm),
        _float0_like(slot_of_edge),
        devals,
        dx,
    )


_spmm_ev_bell.defvjp(_spmm_ev_bell_fwd, _spmm_ev_bell_bwd)


# --------------------------------------------------------------------------- #
# dynamic in-kernel neighbor sampling
# --------------------------------------------------------------------------- #
def _sampled_ell(row_ptr, src, deg, k, ra, rb):
    """Build a fixed-K sampled ELL *on device*: slot j of row r reads
    neighbor (ra*j + rb) %% deg[r] — the reference's in-kernel LCG
    sampling formula (reference: src/codegen/cuda.h:313-320), realized as
    an index transform so the aggregation itself is a regular fixed-K
    gather (an ELL).  Fresh (ra, rb) per epoch gives
    the `dynamic` mode (reference: src/codegen/common.h:822-833)."""
    n = row_ptr.shape[0] - 1
    d = deg[:, 0].astype(jnp.int32)
    j = jnp.arange(k, dtype=jnp.int32)[None, :]
    off = (ra * j + rb) % jnp.maximum(d[:, None], 1)
    # rows with deg < k sample with repetition, like the reference kernel
    idx = row_ptr[:-1, None] + off
    cols = src[idx]
    vals = jnp.where(d[:, None] > 0, 1.0, 0.0).astype(jnp.float32)
    return cols, vals


def _dyn_raw(row_ptr, src, deg, x, k, ra, rb, scale):
    """Sampled aggregation; rows chunk through a rolled lax.scan above
    the gathered-buffer budget (the sampled (N, k, F) gather is the
    same OOM shape as the ELL path at papers100M node counts)."""
    n = row_ptr.shape[0] - 1
    f = x.shape[1]
    rows = max(_BELL_CHUNK_ELEMS // max(k * _phys_cols(f), 1), 1)
    n_chunks = -(-n // rows)

    def reduce(rp_c, deg_c):
        cols, vals = _sampled_ell(
            jnp.concatenate([rp_c, rp_c[-1:]]), src, deg_c, k, ra, rb
        )
        return slot_reduce((vals * scale).astype(x.dtype), x[cols], x.dtype)

    if n_chunks <= 1:
        cols, vals = _sampled_ell(row_ptr, src, deg, k, ra, rb)
        return slot_reduce((vals * scale).astype(x.dtype), x[cols], x.dtype)
    pad = n_chunks * rows - n
    rp = row_ptr[:-1]
    dg = deg
    if pad:
        # padded rows read offset 0 with deg 0 -> vals 0, output dropped
        rp = jnp.concatenate([rp, jnp.zeros((pad,), rp.dtype)])
        dg = jnp.concatenate([dg, jnp.zeros((pad, 1), dg.dtype)])

    def body(_, chunk):
        rp_c, dg_c = chunk
        return 0, reduce(rp_c, dg_c)

    _, out = jax.lax.scan(
        body, 0, (rp.reshape(n_chunks, rows), dg.reshape(n_chunks, rows, 1))
    )
    return out.reshape(n_chunks * rows, f)[:n]


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm_dyn(k, row_ptr, src, deg, t_row_ptr, t_src, t_deg, ra, rb, x):
    return _dyn_raw(row_ptr, src, deg, x, k, ra, rb, 1.0)


def _spmm_dyn_fwd(k, row_ptr, src, deg, t_row_ptr, t_src, t_deg, ra, rb, x):
    out = _dyn_raw(row_ptr, src, deg, x, k, ra, rb, 1.0)
    return out, (t_row_ptr, t_src, t_deg, ra, rb)


def _spmm_dyn_bwd(k, res, dz):
    t_row_ptr, t_src, t_deg, ra, rb = res
    # sampled transpose with the same (ra, rb) — the reference applies
    # the identical sampling formula to its backward (2*layer+1) kernels,
    # an accepted stochastic-gradient approximation
    dx = _dyn_raw(t_row_ptr, t_src, t_deg, dz, k, ra, rb, 1.0)
    z = _float0_like
    return (
        z(t_row_ptr), z(t_src), jnp.zeros_like(t_deg),
        z(t_row_ptr), z(t_src), jnp.zeros_like(t_deg),
        z(jnp.int32(0)), z(jnp.int32(0)), dx,
    )


_spmm_dyn.defvjp(_spmm_dyn_fwd, _spmm_dyn_bwd)


# --------------------------------------------------------------------------- #
# dynamic sampling as slot reweighting on the bell layout
# --------------------------------------------------------------------------- #
# Summing the reference's k picks (ra*i + rb) %% deg WITH repetition
# (reference: src/codegen/cuda.h:313-320) equals weighting CSR position p
# of a degree-d row by w(d, p) = #{i < k : (ra*i + rb) mod d == p}.  The
# sampled aggregation is therefore the ORDINARY bell aggregation with
# per-epoch computed slot weights: zero per-epoch index gathers (the
# (ra*i+rb)-driven src[idx] gather of _dyn_raw reads a whole memory
# line for 4 useful bytes), and the packed/staged gathers apply
# unchanged.
def _dyn_counts(d, p, n_samples, ra, rb):
    """w = #{i < n_samples : (ra*i + rb) mod d == p} as f32, 0 where
    d <= 0 (pad slots / isolated rows)."""
    d1 = jnp.maximum(d, 1)

    def body(i, w):
        return w + ((ra * i + rb) % d1 == p).astype(jnp.float32)

    w0 = jnp.zeros(jnp.broadcast_shapes(d.shape, p.shape), jnp.float32)
    w = jax.lax.fori_loop(0, n_samples, body, w0)
    return jnp.where(d > 0, w, 0.0)


def _dyn_reweight(bell, meta, n_samples, ra, rb):
    """A BellDev whose slot values are this epoch's sampling weights
    (masked by the original occupancy, so pad slots stay 0 and weighted
    graphs keep their edge values as a factor — vals are 1.0 on the
    unweighted graphs sampling targets)."""
    import dataclasses as _dc

    vals_list = list(bell.bin_vals)
    if bell.n_big:
        vals_list.append(bell.big_vals)
    assert len(vals_list) == len(meta.d), (len(vals_list), len(meta.d))
    new = []
    for v, d, p in zip(vals_list, meta.d, meta.p):
        p = p + jax.lax.broadcasted_iota(jnp.int32, (1, v.shape[1]), 1)
        new.append(_dyn_counts(d, p, n_samples, ra, rb) * v)
    big = new.pop() if bell.n_big else None
    return _dc.replace(bell, bin_vals=tuple(new), big_vals=big)


def _dyn_meta_zeros_ct(m):
    import dataclasses as _dc

    return _dc.replace(
        m,
        d=tuple(_float0_like(a) for a in m.d),
        p=tuple(_float0_like(a) for a in m.p),
    )


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _spmm_dyn_bell(n_samples, n_out, c_out, bell, t_bell, mf, mt, ra, rb, x):
    return _bell_raw(_dyn_reweight(bell, mf, n_samples, ra, rb), x, n_out)


def _spmm_dyn_bell_fwd(n_samples, n_out, c_out, bell, t_bell, mf, mt, ra,
                       rb, x):
    out = _bell_raw(_dyn_reweight(bell, mf, n_samples, ra, rb), x, n_out)
    return out, (bell, t_bell, mf, mt, ra, rb)


def _spmm_dyn_bell_bwd(n_samples, n_out, c_out, res, dz):
    bell, t_bell, mf, mt, ra, rb = res
    # sampled transpose with the same (ra, rb): each transpose slot's
    # weight is its FORWARD row's w(deg, pos) — the reference applies the
    # identical formula in its 2*layer+1 kernels
    dx = _bell_raw(_dyn_reweight(t_bell, mt, n_samples, ra, rb), dz, c_out)
    z = _float0_like
    return (
        _bell_zeros_ct(bell), _bell_zeros_ct(t_bell),
        _dyn_meta_zeros_ct(mf), _dyn_meta_zeros_ct(mt),
        z(ra), z(rb), dx,
    )


_spmm_dyn_bell.defvjp(_spmm_dyn_bell_fwd, _spmm_dyn_bell_bwd)


def spmm_sampled(g: Graph, x: jax.Array, k: int, ra, rb) -> jax.Array:
    """Aggregation over k dynamically sampled neighbors per node.

    (ra, rb) are int32 scalars (fresh per epoch for dynamic mode, fixed
    5/7 for static kernel sampling parity with
    reference: src/ops/tiling.h:454).
    """
    if g.strategy == "spmd":
        raise NotImplementedError(
            "dynamic neighbor sampling is single-chip only; compile "
            "without aggrFn.sample(...).dynamic() for SPMD execution"
        )
    ra = jnp.asarray(ra, jnp.int32)
    rb = jnp.asarray(rb, jnp.int32)
    if g.bell is not None and g.dyn_f is not None:
        return _spmm_dyn_bell(
            int(k), g.n_pad, g.c_pad,
            g.bell, g.t_bell, g.dyn_f, g.dyn_t, ra, rb, x,
        )
    t_deg = jnp.diff(g.t_row_ptr).astype(jnp.float32)[:, None]
    return _spmm_dyn(
        int(k),
        g.row_ptr, g.src, g.deg,
        g.t_row_ptr, g.t_src, t_deg,
        ra, rb, x,
    )


# --------------------------------------------------------------------------- #
# custom-vjp segment SpMM: structural edge values (not differentiated)
# --------------------------------------------------------------------------- #
@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _spmm_seg(n_out, c_out, scan, src, dst, t_src, t_dst, vals, t_vals, x):
    return _seg_dispatch(src, dst, vals, x, n_out, scan)


def _spmm_seg_fwd(n_out, c_out, scan, src, dst, t_src, t_dst, vals, t_vals, x):
    out = _seg_dispatch(src, dst, vals, x, n_out, scan)
    return out, (t_src, t_dst, t_vals, src, dst, vals)


def _spmm_seg_bwd(n_out, c_out, scan, res, dz):
    t_src, t_dst, t_vals, src, dst, vals = res
    dx = _seg_dispatch(t_src, t_dst, t_vals, dz, c_out, scan)
    return (
        _float0_like(src), _float0_like(dst),
        _float0_like(t_src), _float0_like(t_dst),
        jnp.zeros_like(vals), jnp.zeros_like(t_vals),
        dx,
    )


_spmm_seg.defvjp(_spmm_seg_fwd, _spmm_seg_bwd)


# --------------------------------------------------------------------------- #
# custom-vjp segment SpMM with learned edge values (GAT path)
# --------------------------------------------------------------------------- #
@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _spmm_ev_seg(n_out, c_out, scan, src, dst, t_src, t_dst, t_perm, vals, x):
    return _seg_dispatch(src, dst, vals, x, n_out, scan)


def _spmm_ev_seg_fwd(n_out, c_out, scan, src, dst, t_src, t_dst, t_perm, vals, x):
    out = _seg_dispatch(src, dst, vals, x, n_out, scan)
    return out, (src, dst, t_src, t_dst, t_perm, vals, x)


def _spmm_ev_seg_bwd(n_out, c_out, scan, res, dz):
    src, dst, t_src, t_dst, t_perm, vals, x = res
    # dx on the transpose graph with the per-edge values permuted into
    # transpose order (the 2*layer+1 graph of the reference).
    dx = _seg_dispatch(t_src, t_dst, vals[t_perm], dz, c_out, scan)
    # dvals: SDDMM(dz, x) in forward edge order (gathers only).
    dvals = sddmm_edges(src, dst, x, dz)
    return (
        _float0_like(src), _float0_like(dst),
        _float0_like(t_src), _float0_like(t_dst), _float0_like(t_perm),
        dvals, dx,
    )


_spmm_ev_seg.defvjp(_spmm_ev_seg_fwd, _spmm_ev_seg_bwd)


# --------------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------------- #
def spmm(g: Graph, x: jax.Array) -> jax.Array:
    """Aggregate node features over the graph: out = A @ x.

    Structural edge values (g.vals); gradient flows to `x` only, via the
    transpose graph.  `x` is (n_pad_src, F); returns (n_pad_dst, F).
    """
    if g.strategy == "spmd":
        # ShardedGraph inside shard_map (gala_tpu.parallel): collectives
        # replace the transpose-graph custom VJP — autodiff reverses the
        # all_gather/all_to_all into the edge-partitioned backward
        from gala_tpu.parallel.ops import (
            spmd_spmm, spmd_spmm_bell, spmd_spmm_halo,
        )

        if getattr(g, "bell", None) is not None:
            # scatter-free per-shard binned reduce (ShardedBell layouts)
            return spmd_spmm_bell(g, x)
        if g.use_halo:
            return spmd_spmm_halo(
                g.src_halo, g.dst_local, g.vals, x, g.send_idx,
                g.rows_per_shard, g.n_shards, g.halo, g.edges_local,
            )
        return spmd_spmm(g.src, g.dst_local, g.vals, x, g.rows_per_shard)
    if g.strategy == "dense":
        return jnp.dot(
            g.a_dense, x,
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
    if g.strategy == "bell":
        return _spmm_bell(g.n_pad, g.c_pad, g.bell, g.t_bell, x)
    if g.strategy == "ell":
        return _spmm_ell(
            g.n_pad, g.c_pad,
            g.ell_cols, g.ell_vals, g.ell_vrow,
            g.t_ell_cols, g.t_ell_vals, g.t_ell_vrow, x,
        )
    scan = (g.scan_chunk or SCAN_CHUNK) if g.strategy == "segment_scan" else 0
    return _spmm_seg(
        g.n_pad, g.c_pad, scan,
        g.src, g.dst, g.t_src, g.t_dst, g.vals, g.t_vals, x,
    )


def spmm_ev(g: Graph, vals: jax.Array, x: jax.Array) -> jax.Array:
    """Aggregate with *learned* per-edge values (forward edge order).

    Gradient flows to both `vals` (SDDMM) and `x` (transpose SpMM) — the
    autograd contract of the reference's SpMM-with-edge-values wrapper
    (reference: src/codegen/common.h:863-892).
    """
    if g.strategy == "spmd":
        from gala_tpu.parallel.ops import (
            spmd_spmm_ev, spmd_spmm_ev_bell, spmd_spmm_halo,
        )

        if (
            getattr(g, "bell", None) is not None
            and g.bell.edge_perm is not None
        ):
            return spmd_spmm_ev_bell(g, vals, x)
        if g.use_halo:
            # the halo kernel has no custom VJP: gradients flow to the
            # learned edge values and the features alike
            return spmd_spmm_halo(
                g.src_halo, g.dst_local, vals, x, g.send_idx,
                g.rows_per_shard, g.n_shards, g.halo, g.edges_local,
            )
        return spmd_spmm_ev(g.src, g.dst_local, vals, x, g.rows_per_shard)
    if g.strategy == "dense":
        a = jnp.zeros((g.n_pad, g.c_pad), x.dtype)
        a = a.at[g.dst, g.src].add(vals, indices_are_sorted=True)
        return jnp.dot(
            a, x,
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
    if g.strategy == "bell":
        # learned edge values need the slot->edge permutation the binned
        # layout does not keep; fall back to the segment path
        if g.src is None:
            raise ValueError(
                "spmm_ev on a 'bell' graph built without edge lists; "
                "rebuild with keep_edges=True (or edge_vals=True)"
            )
        return _spmm_ev_seg(
            g.n_pad, g.c_pad, 0,
            g.src, g.dst, g.t_src, g.t_dst, g.t_perm, vals, x,
        )
    if g.strategy == "ell":
        mask = (g.ell_perm != g.e_pad - 1).astype(x.dtype)
        t_mask = (g.t_ell_perm != g.e_pad - 1).astype(x.dtype)
        return _spmm_ev_ell(
            g.n_pad, g.c_pad,
            g.ell_cols, g.ell_vrow, g.ell_perm, mask,
            g.t_ell_cols, g.t_ell_vrow, g.t_ell_perm, t_mask,
            g.src, g.dst, vals, x,
        )
    scan = (g.scan_chunk or SCAN_CHUNK) if g.strategy == "segment_scan" else 0
    return _spmm_ev_seg(
        g.n_pad, g.c_pad, scan,
        g.src, g.dst, g.t_src, g.t_dst, g.t_perm, vals, x,
    )


def spmm_direct(g: Graph, x: jax.Array) -> jax.Array:
    """Non-differentiable aggregation (AGGREGATE_MUL_SUM_DIRECT,
    reference: src/ir/compute.h:41) — e.g. the degree computation
    A @ ones used for normalization; always detached."""
    return jax.lax.stop_gradient(spmm(g, x))


def degrees(g: Graph) -> jax.Array:
    """In-degree column vector (n_pad, 1) — precomputed at graph build,
    matching SpMM(A, ones) on the padded graph."""
    return g.deg
