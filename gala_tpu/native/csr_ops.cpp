// Native host-side graph preprocessing (OpenMP C++).
//
// Counterpart of the reference's OpenMP runtime library:
//   - CSR build by counting sort  (reference: src/formats/csrc_matrix.h:148-376,
//     src/utils/mtx_sort.h count_atomic/count_sort_place/partial_sum)
//   - row-split ELL construction  (the layout gala_tpu/data/ell.py defines)
//   - train-mask growth for L-hop subgraphs (reference: tests/common.h:20-123
//     getMaskSubgraphs' per-hop max-aggregate propagation)
//
// Exposed as a plain C ABI consumed through ctypes (gala_tpu/native/__init__.py).
// The NumPy implementations remain the portable fallback; these kick in for
// 100M+ edge graphs where single-threaded numpy sorts dominate setup time.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Counting-sort COO (src,dst,vals) into dst-sorted CSR arrays.
// row_ptr must have n_rows+1 entries; out_* must have n_edges entries.
void coo_to_csr_i32(
    int64_t n_rows, int64_t n_edges,
    const int32_t* src, const int32_t* dst, const float* vals,
    int64_t* row_ptr, int32_t* out_src, int32_t* out_dst, float* out_vals)
{
    // counts
    std::memset(row_ptr, 0, sizeof(int64_t) * (n_rows + 1));
    {
        std::atomic<int64_t>* counts =
            reinterpret_cast<std::atomic<int64_t>*>(row_ptr + 1);
#pragma omp parallel for
        for (int64_t e = 0; e < n_edges; ++e) {
            counts[dst[e]].fetch_add(1, std::memory_order_relaxed);
        }
    }
    // prefix sum (serial; n_rows is small relative to edges)
    for (int64_t r = 0; r < n_rows; ++r) row_ptr[r + 1] += row_ptr[r];

    // stable placement: per-row cursors
    int64_t* cursor = new int64_t[n_rows];
#pragma omp parallel for
    for (int64_t r = 0; r < n_rows; ++r) cursor[r] = row_ptr[r];
    {
        std::atomic<int64_t>* cur = reinterpret_cast<std::atomic<int64_t>*>(cursor);
#pragma omp parallel for
        for (int64_t e = 0; e < n_edges; ++e) {
            int64_t pos = cur[dst[e]].fetch_add(1, std::memory_order_relaxed);
            out_src[pos] = src[e];
            out_dst[pos] = dst[e];
            out_vals[pos] = vals ? vals[e] : 1.0f;
        }
    }
    delete[] cursor;
}

// Row-split ELL fill from a dst-sorted CSR.
// vstart: (n_rows+1) precomputed virtual-row offsets (ceil(deg/k) cumsum).
// cols/vals/perm are (v_pad, k) pre-initialized by the caller
// (phantom col / 0 / pad_edge_id); vrow is (v_pad,) pre-initialized.
void fill_ell_i32(
    int64_t n_rows, int64_t k,
    const int64_t* row_ptr, const int32_t* src, const float* csr_vals,
    const int64_t* vstart,
    int32_t* cols, float* vals, int32_t* perm, int32_t* vrow)
{
#pragma omp parallel for schedule(dynamic, 1024)
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t lo = row_ptr[r], hi = row_ptr[r + 1];
        int64_t v0 = vstart[r];
        for (int64_t e = lo; e < hi; ++e) {
            int64_t t = e - lo;
            int64_t v = v0 + t / k;
            int64_t s = t % k;
            cols[v * k + s] = src[e];
            vals[v * k + s] = csr_vals[e];
            perm[v * k + s] = (int32_t)e;
        }
        int64_t nv = vstart[r + 1] - v0;
        for (int64_t v = v0; v < v0 + nv; ++v) vrow[v] = (int32_t)r;
    }
}

// Binned-ELL fill (gala_tpu/data/ell.py build_binned_ell): the absolute
// slot of a node's t-th edge is slot_base[node] + t for every class
// (hub virtual rows are contiguous, so (vbase + t/K)*K + t%K == vbase*K + t).
// cols/vals (and optionally edge ids) are flat pre-initialized arrays.
void fill_bell_i32(
    int64_t n_edges,
    const int32_t* dst, const int32_t* src, const float* csr_vals,
    const int64_t* row_ptr, const int64_t* slot_base,
    int32_t* cols_flat, float* vals_flat, int64_t* edge_flat)
{
#pragma omp parallel for
    for (int64_t i = 0; i < n_edges; ++i) {
        int32_t v = dst[i];
        int64_t slot = slot_base[v] + (i - row_ptr[v]);
        cols_flat[slot] = src[i];
        vals_flat[slot] = csr_vals[i];
        if (edge_flat) edge_flat[slot] = i;
    }
}

// One hop of train-mask growth: mark sources of edges into masked dsts.
void grow_mask_i8(
    int64_t n_edges, const int32_t* src, const int32_t* dst,
    const uint8_t* mask_in, uint8_t* mask_out)
{
#pragma omp parallel for
    for (int64_t e = 0; e < n_edges; ++e) {
        if (mask_in[dst[e]]) mask_out[src[e]] = 1;
    }
}

// Per-chunk dedup for the staged two-level gather tables
// (gala_tpu/data/ell.py build_stage_tables): every chunk's slot ids are
// sorted+uniqued independently, so the chunks parallelize perfectly —
// the NumPy path runs one serial np.unique per chunk, minutes at
// papers100M scale.  uniq_out shares cols' layout (capacity = chunk
// length); uniq_counts[c] gives the used prefix.  local_out[i] is the
// index of cols[i] inside its chunk's uniq prefix.
void stage_dedup_i32(
    int64_t n_chunks, const int64_t* starts, const int64_t* ends,
    const int32_t* cols,
    int32_t* uniq_out, int64_t* uniq_counts, int32_t* local_out)
{
#pragma omp parallel for schedule(dynamic)
    for (int64_t c = 0; c < n_chunks; ++c) {
        const int64_t lo = starts[c], hi = ends[c];
        const int64_t len = hi - lo;
        int32_t* u = uniq_out + lo;
        std::memcpy(u, cols + lo, sizeof(int32_t) * len);
        std::sort(u, u + len);
        int64_t m = 0;
        for (int64_t i = 0; i < len; ++i) {
            if (i == 0 || u[i] != u[m - 1]) u[m++] = u[i];
        }
        uniq_counts[c] = m;
        for (int64_t i = lo; i < hi; ++i) {
            const int32_t* pos = std::lower_bound(u, u + m, cols[i]);
            local_out[i] = (int32_t)(pos - u);
        }
    }
}


// Structural symmetry check: sort-free O(E) two-pass bucket compare.
// Buckets edges by min(endpoint) into per-row slots using the caller's
// row_ptr-style offsets would need CSR of the transpose; instead use a
// parallel sort of 64-bit keys (merge of per-thread sorted runs is
// overkill: std::sort per block + final pairwise compare via a second
// full sort is what NumPy does single-threaded; here each half sorts on
// its own thread team).  Returns 1 if sorted key arrays are equal.
int keys_symmetric_i64(int64_t n_edges, int64_t* key_fwd, int64_t* key_bwd)
{
    // sort both halves concurrently, each with a parallel merge sort:
    // split into T blocks, std::sort each, then iterative merges.
#ifdef _OPENMP
    const int t = omp_get_max_threads();
#else
    const int t = 1;
#endif
    int64_t* bufs[2] = {key_fwd, key_bwd};
    int64_t* scratch = new int64_t[n_edges];
    for (int which = 0; which < 2; ++which) {
        int64_t* a = bufs[which];
        const int64_t nb = t;
        const int64_t bs = (n_edges + nb - 1) / nb;
#pragma omp parallel for schedule(dynamic)
        for (int64_t b = 0; b < nb; ++b) {
            const int64_t lo = b * bs;
            const int64_t hi = std::min(lo + bs, n_edges);
            if (lo < hi) std::sort(a + lo, a + hi);
        }
        // iterative pairwise merges (log nb rounds)
        for (int64_t width = bs; width < n_edges; width *= 2) {
#pragma omp parallel for schedule(dynamic)
            for (int64_t lo = 0; lo < n_edges; lo += 2 * width) {
                const int64_t mid = std::min(lo + width, n_edges);
                const int64_t hi = std::min(lo + 2 * width, n_edges);
                if (mid < hi) {
                    std::merge(a + lo, a + mid, a + mid, a + hi, scratch + lo);
                    std::memcpy(a + lo, scratch + lo,
                                sizeof(int64_t) * (hi - lo));
                }
            }
        }
    }
    delete[] scratch;
    int equal = 1;
#pragma omp parallel for reduction(&& : equal)
    for (int64_t e = 0; e < n_edges; ++e)
        equal = equal && (key_fwd[e] == key_bwd[e]);
    return equal;
}

int omp_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// Random-geometric-graph neighbor search over a grid hash
// (reference generator family: src/utils/generator.h generate_rgg2D).
// The caller buckets nodes by cell (counting sort in NumPy is fast);
// these passes do the O(9 * avg_cell_occupancy) distance tests per node
// that dominate generation — the Python per-node loop costs ~160s at
// 1.5M nodes / 25M edges, this path ~2s.
//
// Pass 1: per-cell directed-edge counts (i in cell, any j != i within
// radius).  Pass 2: fill (src, dst) at the caller-prefix-summed
// offsets.  Both parallelize over cells.
void rgg2d_count(
    int64_t nx, const double* px, const double* py, double r2,
    const int64_t* cell_start, const int32_t* nodes_by_cell,
    int64_t* counts)
{
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t c = 0; c < nx * nx; ++c) {
        int64_t cx = c / nx, cy = c % nx, cnt = 0;
        for (int64_t ii = cell_start[c]; ii < cell_start[c + 1]; ++ii) {
            int32_t i = nodes_by_cell[ii];
            double xi = px[i], yi = py[i];
            for (int64_t dx = -1; dx <= 1; ++dx) {
                int64_t ax = cx + dx;
                if (ax < 0 || ax >= nx) continue;
                for (int64_t dy = -1; dy <= 1; ++dy) {
                    int64_t ay = cy + dy;
                    if (ay < 0 || ay >= nx) continue;
                    int64_t cc = ax * nx + ay;
                    for (int64_t jj = cell_start[cc]; jj < cell_start[cc + 1]; ++jj) {
                        int32_t j = nodes_by_cell[jj];
                        if (j == i) continue;
                        double ddx = px[j] - xi, ddy = py[j] - yi;
                        if (ddx * ddx + ddy * ddy < r2) ++cnt;
                    }
                }
            }
        }
        counts[c] = cnt;
    }
}

void rgg2d_fill(
    int64_t nx, const double* px, const double* py, double r2,
    const int64_t* cell_start, const int32_t* nodes_by_cell,
    const int64_t* offsets, int32_t* out_src, int32_t* out_dst)
{
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t c = 0; c < nx * nx; ++c) {
        int64_t cx = c / nx, cy = c % nx, w = offsets[c];
        for (int64_t ii = cell_start[c]; ii < cell_start[c + 1]; ++ii) {
            int32_t i = nodes_by_cell[ii];
            double xi = px[i], yi = py[i];
            for (int64_t dx = -1; dx <= 1; ++dx) {
                int64_t ax = cx + dx;
                if (ax < 0 || ax >= nx) continue;
                for (int64_t dy = -1; dy <= 1; ++dy) {
                    int64_t ay = cy + dy;
                    if (ay < 0 || ay >= nx) continue;
                    int64_t cc = ax * nx + ay;
                    for (int64_t jj = cell_start[cc]; jj < cell_start[cc + 1]; ++jj) {
                        int32_t j = nodes_by_cell[jj];
                        if (j == i) continue;
                        double ddx = px[j] - xi, ddy = py[j] - yi;
                        if (ddx * ddx + ddy * ddy < r2) {
                            out_src[w] = i;
                            out_dst[w] = j;
                            ++w;
                        }
                    }
                }
            }
        }
    }
}

}  // extern "C"
