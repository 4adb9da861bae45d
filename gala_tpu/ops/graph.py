"""Device-side graph container for the aggregation executors.

Replaces the reference's per-layer `global_{offset,columns,value}_graph`
device arrays (reference: src/codegen/cuda.h:1053-1331): the forward graph
lives at index 2*layer and its transpose (backward graph) at 2*layer+1,
aliased when the graph is undirected.  Here a single `Graph` pytree holds
both orientations plus the dense form when the dense strategy is selected.

Layout decisions:
- Edges are *destination-sorted* with CSR-style row offsets, padded to a
  multiple of 128 phantom edges targeting phantom row `n_nodes`, so every
  kernel sees static shapes (XLA requirement).
- Node dimension is padded to a multiple of 8 (f32 sublane) including one
  phantom row that absorbs padded-edge contributions.
- `strategy` selects the execution path for aggregation:
    'dense'        adjacency densified once; SpMM = one matmul.  For
                   small graphs 2*N^2*F FLOPs on the matrix units beat
                   scatter-bound sparse code.
    'bell'         binned ELL: scatter-free degree-class gathers and
                   dense reductions (gala_tpu.data.ell).
    'ell'          row-split ELL; its slot->edge permutation carries
                   learned edge values.
    'segment'      gather + sorted segment_sum (one shot).  O(E*F) bytes
                   of intermediate; for small E*F.
    'segment_scan' lax.scan over edge chunks with an (N,F) accumulator;
                   bounded memory for large graphs (the analog of the
                   reference's ordered column tiling, reference:
                   src/ops/tiling.h:222-284).
    'auto'         density/size heuristic, the input-aware compilation
                   analog (reference: tests/gala_inference.cpp:84-131).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.data.csr import HostCSR, transpose as host_transpose, is_symmetric, densify

EDGE_PAD = 128
NODE_PAD = 8


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BellDev:
    """Device arrays of a binned ELL (see gala_tpu.data.ell.build_binned_ell).

    One flat gather feeds per-degree-class dense reductions; only hub
    nodes use a (tiny) segment-sum.  `out_index` reorders bin-order output
    back to global node order ((n_pad,) gather; None when the graph was
    pre-relabeled with bell_order so bin order IS global order)."""

    flat_cols: jax.Array                 # (S,) int32
    bin_vals: tuple                      # per bin (n_b, k_b) f32
    big_vals: jax.Array | None           # (Vb, K_BIG) f32
    big_vrow: jax.Array | None           # (Vb,) int32 sorted
    diag: jax.Array | None               # (n_pad, 1) f32, global order
    out_index: jax.Array | None          # (n_pad,) int32 into bin-order+1 rows
    # staged-gather dedup tables (gala_tpu.data.ell.build_stage_tables):
    # per canonical chunk a (uniq_ids, local_idx) pair; None when the
    # graph is small enough that the direct gather is already fast
    stage: tuple | None
    bin_ks: tuple                        # static
    bin_counts: tuple                    # static
    n_big: int                           # static
    n_real: int                          # static: real node count
    uniq_frac: float = 1.0               # static: mean per-chunk unique frac
    chunk_slots: int = 0                 # static: schedule-driven chunk size
                                         # (0 = canonical data.ell.S_CHUNK)

    def tree_flatten(self):
        children = (
            self.flat_cols, self.bin_vals, self.big_vals,
            self.big_vrow, self.diag, self.out_index, self.stage,
        )
        aux = (self.bin_ks, self.bin_counts, self.n_big, self.n_real,
               self.uniq_frac, self.chunk_slots)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, hb, n_pad: int, n_real: int,
                  stage_tables=None, chunk_slots: int = 0) -> "BellDev":
        diag = None
        if hb.diag is not None:
            d = np.zeros((n_pad, 1), np.float32)
            d[:n_real, 0] = hb.diag
            diag = jnp.asarray(d)
        out_index = None
        if not hb.identity_order:
            # position of each global node in bin order; padding rows point
            # at the appended zero row (index n_real)
            inv = np.full(n_pad, n_real, np.int32)
            inv[hb.order] = np.arange(n_real, dtype=np.int32)
            out_index = jnp.asarray(inv)
        stage = None
        uniq_frac = 1.0
        if stage_tables is not None:
            stage = tuple(
                (jnp.asarray(u), jnp.asarray(l))
                for u, l in zip(stage_tables.uniq, stage_tables.local)
            )
            uniq_frac = stage_tables.uniq_frac
        return cls(
            flat_cols=jnp.asarray(hb.flat_cols),
            bin_vals=tuple(jnp.asarray(v) for v in hb.bin_vals),
            big_vals=jnp.asarray(hb.big_vals) if hb.big_vals is not None else None,
            big_vrow=jnp.asarray(hb.big_vrow) if hb.big_vrow is not None else None,
            diag=diag,
            out_index=out_index,
            stage=stage,
            bin_ks=hb.bin_ks,
            bin_counts=hb.bin_counts,
            n_big=hb.n_big,
            n_real=n_real,
            uniq_frac=uniq_frac,
            chunk_slots=chunk_slots,
        )

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DynMeta:
    """Device arrays of a HostDynMeta (data.ell): per-segment sampling
    weight inputs for the reweighted-bell dynamic path
    (ops.spmm._spmm_dyn_bell)."""

    d: tuple            # per segment (nb, 1) int32 row degrees
    p: tuple            # per segment (nb, 1) int32 slot-0 in-row offsets

    def tree_flatten(self):
        return (self.d, self.p), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_host(cls, hm) -> "DynMeta":
        return cls(
            d=tuple(jnp.asarray(a) for a in hm.d),
            p=tuple(jnp.asarray(a) for a in hm.p),
        )


# Above this many scalar elements the one-shot (E,F) gather intermediate is
# scanned in chunks instead (keeps peak memory ~CHUNK*F).
_SEGMENT_ONESHOT_LIMIT = 1 << 27  # 128M elements ~ 512MB f32
# N_pad^2 f32 <= 1GB; dense wins below this size (inherited constant,
# not yet measured on the GPU)
_DENSE_MAX_NODES = 16384
# build stage tables when a bf16 feature table could cross the gather
# cliff (the runtime gate ops.spmm._STAGE_MIN_BYTES decides per dtype)
_STAGE_BUILD_BYTES = 72 << 20
# beyond this per-chunk unique fraction staging loses to the direct
# gather (model in data.ell.HostStageTables; inherited constant, not
# yet measured on the GPU)
_STAGE_MAX_UNIQ_FRAC = 0.55


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Graph:
    """Static-shape, dst-sorted edge list on device (+ transpose, + dense)."""

    # --- pytree children (device arrays) ---
    src: jax.Array          # (E_pad,) int32 source node per edge
    dst: jax.Array          # (E_pad,) int32 destination node, ascending
    vals: jax.Array         # (E_pad,) f32 structural edge values (0 on pad)
    t_src: jax.Array        # transpose graph: (E_pad,) int32
    t_dst: jax.Array        # (E_pad,) int32, ascending
    t_vals: jax.Array       # (E_pad,) f32
    t_perm: jax.Array       # (E_pad,) int32: forward edge id of transpose edge i
    a_dense: jax.Array | None   # (N_pad, C_pad) f32, only for 'dense'
    deg: jax.Array          # (N_pad, 1) f32 in-degrees (0 on padding)
    row_ptr: jax.Array      # (n_pad+1,) int32 CSR offsets (device, for
                            # dynamic in-kernel sampling)
    t_row_ptr: jax.Array    # (c_pad+1,) int32 transpose offsets
    # row-split ELL layout (strategy 'ell'; see gala_tpu.data.ell)
    ell_cols: jax.Array | None      # (V, K) int32
    ell_vals: jax.Array | None      # (V, K) f32
    ell_vrow: jax.Array | None      # (V,) int32
    ell_perm: jax.Array | None      # (V, K) int32 -> forward edge id
    t_ell_cols: jax.Array | None
    t_ell_vals: jax.Array | None
    t_ell_vrow: jax.Array | None
    t_ell_perm: jax.Array | None
    # binned ELL layout (strategy 'bell'; see gala_tpu.data.ell)
    bell: "BellDev | None"
    t_bell: "BellDev | None"
    # fused slot-space attention layout (gala_tpu.ops.attention)
    attn: object | None
    # dynamic-sampling reweighting meta (built when the schedule says
    # aggrFn.sample(k).dynamic(); see DynMeta / ops.spmm._spmm_dyn_bell)
    dyn_f: "DynMeta | None"
    dyn_t: "DynMeta | None"

    # --- static aux ---
    n_nodes: int            # real node count
    n_cols: int             # real source-side node count (== n_nodes here)
    n_pad: int              # padded node count (>= n_nodes+1)
    c_pad: int              # padded source-side count
    n_edges: int            # real edge count
    e_pad: int              # padded edge count
    undirected: bool
    strategy: str
    # schedule-driven ordered column tiling (DIR `col_tile` directive,
    # reference: src/ops/tiling.h:222-284): edges per segment_scan chunk
    # (0 = module default) — the bell/attention analog rides
    # bell.chunk_slots
    scan_chunk: int = 0

    # ------------------------------------------------------------------ #
    def tree_flatten(self):
        children = (
            self.src, self.dst, self.vals,
            self.t_src, self.t_dst, self.t_vals, self.t_perm,
            self.a_dense, self.deg,
            self.row_ptr, self.t_row_ptr,
            self.ell_cols, self.ell_vals, self.ell_vrow, self.ell_perm,
            self.t_ell_cols, self.t_ell_vals, self.t_ell_vrow, self.t_ell_perm,
            self.bell, self.t_bell, self.attn, self.dyn_f, self.dyn_t,
        )
        aux = (
            self.n_nodes, self.n_cols, self.n_pad, self.c_pad,
            self.n_edges, self.e_pad, self.undirected, self.strategy,
            self.scan_chunk,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_host(
        cls,
        g: HostCSR,
        strategy: str = "auto",
        undirected: bool | None = None,
        edge_vals: bool = False,
        attention: bool = False,
        keep_edges: bool | str = "auto",
        col_tile: float | None = None,
        long_indices: bool = False,
        dynamic_sample: bool = False,
    ) -> "Graph":
        """keep_edges: upload the raw (padded) edge lists and transpose
        permutation.  The bell layout never reads them, and at scale the
        host->device transfer dominates preprocessing; 'auto' keeps them
        only for strategies that consume them (edge_vals fallbacks,
        segment paths, dense spmm_ev, in-kernel sampling — pass True
        when dynamic sampling is scheduled)."""
        # is_symmetric costs two full edge argsorts — only pay it when
        # the answer is consulted (undirected None = auto-detect, or
        # True = value-check before aliasing the transpose layout)
        symmetric = is_symmetric(g) if undirected is None or undirected else False
        if undirected is None:
            undirected = symmetric

        n = g.n_rows
        c = g.n_cols
        n_pad = _round_up(n + 1, NODE_PAD)
        c_pad = _round_up(c + 1, NODE_PAD)
        e_real = g.n_edges
        # always at least one padded (zero-val) edge: slot E_pad-1 is the
        # safe sink for ELL padding permutation indices
        e_pad = _round_up(e_real + 1, EDGE_PAD)
        # EDGE ids/offsets overflow int32 past 2^31 edges (papers100M
        # full-graph territory); the `inference_long` driver / use_long
        # schedule flag widens exactly those arrays.  Node ids stay
        # int32 (valid to 2^31 nodes).
        eid = np.int64 if (long_indices or e_pad >= 2**31) else np.int32
        if eid is np.int64 and not jax.config.jax_enable_x64:
            # jnp.asarray would silently canonicalize int64 -> int32
            # (wraparound offsets, garbage gathers) — refuse instead
            raise ValueError(
                "int64 edge indices require x64 mode: call "
                'jax.config.update("jax_enable_x64", True) before any jax '
                "op (the inference_long driver does this automatically)"
            )

        if strategy == "auto":
            strategy = choose_strategy(n_pad, c_pad, e_real, edge_vals=edge_vals)
        check_strategy(strategy)
        if keep_edges == "auto":
            keep_edges = edge_vals or strategy != "bell"

        # DIR col_tile (source rows per ordered column tile) -> executed
        # chunk granularities: edges per scan chunk for the segment
        # paths, slots per gather chunk for the bell/attention paths
        chunk_slots = 0
        scan_chunk = 0
        if col_tile:
            tile_rows = max(int(col_tile), 1)
            mean_deg = max(e_real / max(c, 1), 1.0)
            tile_edges = int(tile_rows * mean_deg)
            scan_chunk = max(_round_up(tile_edges, EDGE_PAD), EDGE_PAD)
            chunk_slots = max(_round_up(tile_edges, 4096), 4096)

        def pad_edges(dstv, srcv, valsv, phantom_dst, phantom_src):
            pad = e_pad - dstv.shape[0]
            dstv = np.concatenate([dstv, np.full(pad, phantom_dst, np.int64)]).astype(np.int32)
            srcv = np.concatenate([srcv, np.full(pad, phantom_src, np.int64)]).astype(np.int32)
            valsv = np.concatenate([valsv, np.zeros(pad, np.float32)])
            return dstv, srcv, valsv

        dst = src = vals = t_dst = t_src = t_vals = t_perm = None
        if keep_edges:
            dst, src, vals = pad_edges(g.dst, g.src, g.vals, n, 0)
            # transpose graph (backward pass); perm maps transpose edge -> fwd
            order = np.lexsort((g.dst.astype(np.int64), g.src.astype(np.int64)))
            t_dst, t_src, t_vals = pad_edges(
                g.src[order], g.dst[order], g.vals[order], c, 0
            )
            t_perm = np.concatenate(
                [order, np.full(e_pad - e_real, e_pad - 1, np.int64)]
            ).astype(eid)

        deg_np = np.zeros((n_pad, 1), np.float32)
        deg_np[: n, 0] = np.bincount(g.dst, weights=None, minlength=n).astype(np.float32)

        # device CSR offsets (padded rows are empty) for in-kernel sampling
        row_ptr_np = np.full(n_pad + 1, e_real, eid)
        row_ptr_np[: n + 1] = g.row_ptr.astype(eid)
        t_counts = np.bincount(g.src, minlength=c)
        t_row_ptr_np = np.full(c_pad + 1, e_real, eid)
        t_row_ptr_np[0] = 0
        t_row_ptr_np[1 : c + 1] = np.cumsum(t_counts).astype(eid)

        a_dense = None
        if strategy == "dense":
            d = np.zeros((n_pad, c_pad), np.float32)
            d[: n, : c] = densify(g)
            a_dense = jnp.asarray(d)

        attn = None
        if attention and strategy == "bell":
            from gala_tpu.ops.attention import AttnBell

            attn = AttnBell.from_host(g, n_pad, c_pad, chunk_slots=chunk_slots)

        bell = t_bell = dyn_f = dyn_t = None
        if strategy == "bell":
            from gala_tpu.data.ell import build_binned_ell, build_stage_tables

            # staged-gather dedup tables pay off once the feature table's
            # physical footprint crosses the measured gather cliff
            # (ops.spmm._STAGE_MIN_BYTES); build them whenever a
            # realistic table could get there — gated PER SIDE on that
            # side's own gather-table rows (fwd gathers from the c-row
            # source table, the transpose from the n-row dz table)
            from gala_tpu.data.ell import S_CHUNK

            def _stage(hb, table_rows):
                if table_rows * 128 * 2 <= _STAGE_BUILD_BYTES:
                    return None
                st = build_stage_tables(hb, chunk_slots or S_CHUNK)
                # high-uniq-frac tables lose to the direct gather;
                # skip the device upload entirely
                return st if st.uniq_frac < _STAGE_MAX_UNIQ_FRAC else None

            # dynamic sampling bells keep self loops as slots
            # (split_diag=False): the reference samples positions over
            # the FULL row, so slot position must equal CSR position
            # (data.ell.HostDynMeta)
            hb = build_binned_ell(g, phantom_col=c,
                                  split_diag=not dynamic_sample)
            bell = BellDev.from_host(hb, n_pad, n, stage_tables=_stage(hb, c),
                                     chunk_slots=chunk_slots)
            # alias the backward layout ONLY when A == A^T by VALUE: a
            # caller passing undirected=True on a structurally symmetric
            # graph with asymmetric weights must still get the true
            # transpose (otherwise gradients flow through wrong weights)
            if dynamic_sample:
                from gala_tpu.data.ell import build_dyn_row_meta

                deg_full = np.bincount(g.dst, minlength=n).astype(np.int64)
                dyn_f = DynMeta.from_host(build_dyn_row_meta(hb, deg_full))
            if undirected and symmetric:
                t_bell = bell
                dyn_t = dyn_f
            else:
                hbt = build_binned_ell(host_transpose(g), phantom_col=n,
                                       split_diag=not dynamic_sample)
                t_bell = BellDev.from_host(hbt, c_pad, c, stage_tables=_stage(hbt, n),
                                           chunk_slots=chunk_slots)
                if dynamic_sample:
                    # backward RE-SAMPLES the transpose rows with the same
                    # (ra, rb) — the reference applies the identical
                    # sampling formula in its 2*layer+1 kernels (an
                    # accepted stochastic-gradient approximation), so the
                    # transpose side carries row-form meta of its own
                    t_deg_full = np.bincount(g.src, minlength=c).astype(
                        np.int64
                    )
                    dyn_t = DynMeta.from_host(
                        build_dyn_row_meta(hbt, t_deg_full)
                    )

        ell = t_ell = None
        if strategy == "ell":
            from gala_tpu.data.ell import build_ell

            ell = build_ell(g, phantom_col=c, phantom_row=n, pad_edge_id=e_pad - 1)
            # transpose built with an explicitly stable order so each gt
            # edge j maps deterministically to forward edge t_order[j]
            # (the native counting sort is not stable across threads)
            t_order = np.argsort(g.src, kind="stable")
            t_counts2 = np.bincount(g.src, minlength=c)
            gt_row_ptr = np.zeros(c + 1, np.int64)
            np.cumsum(t_counts2, out=gt_row_ptr[1:])
            gt = HostCSR(
                n_rows=c, n_cols=n, row_ptr=gt_row_ptr,
                dst=g.src[t_order].astype(np.int32),
                src=g.dst[t_order].astype(np.int32),
                vals=g.vals[t_order],
            )
            # transpose slots map to *forward* edge ids so learned edge
            # values permute straight into the backward layout
            t_ell = build_ell(
                gt, k=ell.k, phantom_col=n, phantom_row=c, pad_edge_id=e_pad - 1
            )
            real = t_ell.perm != e_pad - 1
            t_perm_vals = t_ell.perm.copy()
            t_perm_vals[real] = t_order[t_ell.perm[real]].astype(eid)
            t_ell = dataclasses.replace(t_ell, perm=t_perm_vals)

        def put(a):
            return jnp.asarray(a) if a is not None else None

        return cls(
            src=put(src),
            dst=put(dst),
            vals=put(vals),
            t_src=put(t_src),
            t_dst=put(t_dst),
            t_vals=put(t_vals),
            t_perm=put(t_perm),
            a_dense=a_dense,
            deg=jnp.asarray(deg_np),
            row_ptr=jnp.asarray(row_ptr_np),
            t_row_ptr=jnp.asarray(t_row_ptr_np),
            ell_cols=jnp.asarray(ell.cols) if ell else None,
            ell_vals=jnp.asarray(ell.vals) if ell else None,
            ell_vrow=jnp.asarray(ell.vrow) if ell else None,
            ell_perm=jnp.asarray(ell.perm.astype(eid)) if ell else None,
            t_ell_cols=jnp.asarray(t_ell.cols) if t_ell else None,
            t_ell_vals=jnp.asarray(t_ell.vals) if t_ell else None,
            t_ell_vrow=jnp.asarray(t_ell.vrow) if t_ell else None,
            t_ell_perm=jnp.asarray(t_ell.perm.astype(eid)) if t_ell else None,
            bell=bell,
            t_bell=t_bell,
            attn=attn,
            dyn_f=dyn_f,
            dyn_t=dyn_t,
            n_nodes=n,
            n_cols=c,
            n_pad=n_pad,
            c_pad=c_pad,
            n_edges=e_real,
            e_pad=e_pad,
            undirected=undirected,
            strategy=strategy,
            scan_chunk=scan_chunk,
        )

    # ------------------------------------------------------------------ #
    def pad_nodes(self, x: np.ndarray) -> jnp.ndarray:
        """Pad a host (N, ...) node array to (n_pad, ...) and move to device."""
        x = np.asarray(x)
        pad = self.n_pad - x.shape[0]
        if pad > 0:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return jnp.asarray(x)

    def density(self) -> float:
        return self.n_edges / float(max(self.n_nodes, 1) ** 2)


STRATEGIES = ("auto", "dense", "bell", "ell", "segment", "segment_scan")


def check_strategy(strategy: str) -> None:
    """Reject an aggregation strategy this build does not implement."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown aggregation strategy {strategy!r}; "
            f"choose one of {', '.join(STRATEGIES)}"
        )


def choose_strategy(
    n_pad: int,
    c_pad: int,
    e_real: int,
    edge_vals: bool = False,
) -> str:
    """Input-aware strategy selection (the analog of the reference's
    density heuristic, reference: tests/gala_inference.cpp:84-131).

    - Small graphs: densify; a dense matmul beats the sparse paths
      below _DENSE_MAX_NODES.
    - Learned per-edge values (GAT): row-split ELL (its slot->edge-id
      permutation carries attention weights into the layout).
    - Otherwise binned ELL: scatter-free degree-class reduction
      (see gala_tpu.data.ell for the rationale).
    """
    if max(n_pad, c_pad) <= _DENSE_MAX_NODES:
        return "dense"
    return "ell" if edge_vals else "bell"
