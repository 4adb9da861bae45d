"""Host-side sparse-graph construction (NumPy).

Counterpart of the reference's OpenMP CSR machinery
(reference: src/formats/csrc_matrix.h:148-376 `CSRCMatrix::build`,
src/utils/mtx_sort.h counting sorts).  The device executors consume
*edge lists sorted by destination row* (plus row pointers), so the
canonical host format here is a sorted-COO + CSR hybrid:

    row_ptr : (n_rows+1,) int32   CSR offsets over dst-sorted edges
    dst     : (n_edges,)  int32   destination (row) ids, ascending
    src     : (n_edges,)  int32   source (column) ids
    vals    : (n_edges,)  float32 edge values (1.0 when unweighted)

All builds are O(E) counting sorts, the NumPy equivalents of the
reference's `count_atomic`/`count_sort_place` pipeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostCSR:
    """A dst-sorted edge list with CSR row pointers (host / NumPy)."""

    n_rows: int
    n_cols: int
    row_ptr: np.ndarray  # (n_rows+1,) int64-safe offsets, stored int64
    dst: np.ndarray      # (E,) int32, sorted ascending
    src: np.ndarray      # (E,) int32
    vals: np.ndarray     # (E,) float32

    @property
    def n_edges(self) -> int:
        return int(self.dst.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        """Row (in-)degrees: number of incoming edges per destination node."""
        return np.diff(self.row_ptr).astype(np.int32)

    def density(self) -> float:
        n = max(self.n_rows, 1)
        return self.n_edges / float(n * n)


def coo_to_csr(
    src: np.ndarray,
    dst: np.ndarray,
    vals: np.ndarray | None,
    n_rows: int,
    n_cols: int | None = None,
) -> HostCSR:
    """Build a dst-sorted CSR from a COO edge list (counting sort, O(E)).

    Mirrors `CSRCMatrix::build` (reference: src/formats/csrc_matrix.h:148)
    but keyed on *dst* because aggregation reduces into destination rows.
    """
    n_cols = n_rows if n_cols is None else n_cols
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    e = src.shape[0]

    # OpenMP counting sort for large graphs (reference: csrc_matrix.h:148)
    if e > 1_000_000 and n_rows < 2**31 and n_cols < 2**31:
        from gala_tpu import native

        res = native.coo_to_csr_native(src, dst, vals, n_rows)
        if res is not None:
            row_ptr, out_src, out_dst, out_vals = res
            return HostCSR(
                n_rows=n_rows, n_cols=n_cols, row_ptr=row_ptr,
                dst=out_dst, src=out_src, vals=out_vals,
            )

    if vals is None:
        vals = np.ones(e, dtype=np.float32)
    else:
        vals = np.asarray(vals, dtype=np.float32)

    counts = np.bincount(dst, minlength=n_rows)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    order = np.argsort(dst, kind="stable")
    return HostCSR(
        n_rows=n_rows,
        n_cols=n_cols,
        row_ptr=row_ptr,
        dst=dst[order].astype(np.int32),
        src=src[order].astype(np.int32),
        vals=vals[order],
    )


def transpose(g: HostCSR) -> HostCSR:
    """CSR of the reverse graph (dst<->src swapped, re-sorted).

    This is the backward-pass graph: the reference stores it at global
    index 2*layer+1 (reference: src/codegen/cuda.h:1092-1299) and aliases
    it to the forward graph when the graph is undirected.
    """
    return coo_to_csr(g.dst, g.src, g.vals, n_rows=g.n_cols, n_cols=g.n_rows)


def is_symmetric(g: HostCSR) -> bool:
    """True if the weighted adjacency equals its transpose (A == A^T).

    Values matter: a structurally symmetric graph with asymmetric weights
    must NOT alias its backward (transpose) graph."""
    if g.n_rows != g.n_cols:
        return False
    # cheap necessary condition first: A == A^T implies in-degree ==
    # out-degree per node (O(E) bincounts) — directed graphs reject here
    # without paying the two O(E log E) argsorts (23s at 46M edges)
    out_deg = np.bincount(g.dst, minlength=g.n_rows)
    in_deg = np.bincount(g.src, minlength=g.n_rows)
    if not np.array_equal(out_deg, in_deg):
        return False
    key_fwd = g.dst.astype(np.int64) * g.n_cols + g.src
    key_bwd = g.src.astype(np.int64) * g.n_rows + g.dst
    if g.vals.size == 0 or np.all(g.vals == g.vals.flat[0]):
        # constant values (the npy-layout convention sets all to 1):
        # only structure matters — parallel native sort+compare when
        # available (reference analog: OpenMP mtx_sort.h), else np.sort
        # (beats argsort + two gathers ~2x at 46M edges)
        from gala_tpu import native

        if native.thread_count() > 1:  # 1-core hosts: np.sort wins
            r = native.keys_symmetric_native(key_fwd, key_bwd)
            if r is not None:
                return r
        return bool(np.array_equal(np.sort(key_fwd), np.sort(key_bwd)))
    of, ob = np.argsort(key_fwd), np.argsort(key_bwd)
    return bool(
        np.array_equal(key_fwd[of], key_bwd[ob])
        and np.array_equal(g.vals[of], g.vals[ob])
    )


def normalize_self_loops(
    src: np.ndarray, dst: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Drop existing self loops, dedupe edges, then add one self loop per node.

    Matches the reference dataset export convention
    (reference: scripts/Data/gala_export_npy.py:73-74 — remove_self_loop
    followed by add_self_loop before writing Adj npys).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    key = np.unique(key)
    src, dst = key // n, key % n
    loop = np.arange(n, dtype=np.int64)
    return np.concatenate([src, loop]), np.concatenate([dst, loop])


def symmetrize(src: np.ndarray, dst: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Make an edge list undirected (union with reversed edges, deduped).

    Counterpart of the DSL directive `G.set_undirected(true)`
    (reference: src/frontend/frontend.y:297).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = np.unique(a * n + b)
    return key // n, key % n


def pad_edges(g: HostCSR, multiple: int = 128) -> tuple[HostCSR, int]:
    """Pad the edge list to a multiple of `multiple` with phantom edges.

    Phantom edges point at a phantom row `n_rows` with value 0, so device
    kernels can run on static shapes and reductions into row `n_rows` are
    discarded.  Returns (padded graph, real edge count).
    """
    e = g.n_edges
    pe = ((e + multiple - 1) // multiple) * multiple
    if pe == e:
        return g, e
    pad = pe - e
    dst = np.concatenate([g.dst, np.full(pad, g.n_rows, dtype=np.int32)])
    src = np.concatenate([g.src, np.full(pad, min(g.n_cols, g.n_rows), dtype=np.int32)])
    vals = np.concatenate([g.vals, np.zeros(pad, dtype=np.float32)])
    row_ptr = np.concatenate([g.row_ptr, np.asarray([pe], dtype=np.int64)])
    return (
        HostCSR(n_rows=g.n_rows, n_cols=g.n_cols, row_ptr=row_ptr, dst=dst, src=src, vals=vals),
        e,
    )


@dataclasses.dataclass
class HostDCSR:
    """Doubly-compressed CSR: row pointers only for non-empty rows.

    The reference's DCSR (reference: src/formats/csrc_matrix.h
    `import_dcsr`, CMake `SM_TYPE=3`/`C_COMP`) compresses away empty
    rows — profitable for hypersparse tiles and mask-grown training
    subgraphs where most rows have no edges.  Here the binned-ELL
    layout already skips empty rows on device, so this stays a host
    format (IO / analysis / memory-bounded preprocessing).
    """

    n_rows: int              # logical row count (uncompressed space)
    n_cols: int
    rows: np.ndarray         # (nzr,) int32 non-empty row ids, ascending
    row_ptr: np.ndarray      # (nzr+1,) offsets over the edge arrays
    src: np.ndarray          # (E,) int32
    vals: np.ndarray         # (E,) float32

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def to_dcsr(g: HostCSR) -> HostDCSR:
    """Compress empty rows out of the row-pointer array (CSR -> DCSR)."""
    deg = np.diff(g.row_ptr)
    rows = np.flatnonzero(deg).astype(np.int32)
    rp = np.zeros(rows.shape[0] + 1, np.int64)
    np.cumsum(deg[rows], out=rp[1:])
    return HostDCSR(
        n_rows=g.n_rows, n_cols=g.n_cols, rows=rows, row_ptr=rp,
        src=g.src.copy(), vals=g.vals.copy(),
    )


def from_dcsr(d: HostDCSR) -> HostCSR:
    """Re-expand a DCSR into the canonical dst-sorted CSR."""
    deg = np.zeros(d.n_rows, np.int64)
    deg[d.rows] = np.diff(d.row_ptr)
    rp = np.zeros(d.n_rows + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    dst = np.repeat(d.rows.astype(np.int32), np.diff(d.row_ptr))
    return HostCSR(
        n_rows=d.n_rows, n_cols=d.n_cols, row_ptr=rp, dst=dst,
        src=d.src.copy(), vals=d.vals.copy(),
    )


def densify(g: HostCSR) -> np.ndarray:
    """Dense (n_rows, n_cols) float32 adjacency — the dense-matmul path
    for small graphs (strategy selection in gala_tpu.ops.spmm)."""
    a = np.zeros((g.n_rows, g.n_cols), dtype=np.float32)
    # += semantics for duplicate edges via np.add.at
    np.add.at(a, (g.dst.astype(np.int64), g.src.astype(np.int64)), g.vals)
    return a
