"""Edge-level operations: SDDVV, SDDMM, edge softmax.

JAX replacements for the reference's generated edge kernels
(reference: src/codegen/cuda.h:504-953 — `edge_sddvv`, `edge_sddmm`,
`inplace_softmax_sddvv{,_mult}`) and their autograd wrappers
(reference: src/codegen/common.h:700-1084).

All edge tensors are in *forward (dst-sorted) edge order*; per-destination
reductions are sorted segment reductions, the analog of the
reference's warp-per-row segment scans.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gala_tpu.ops.graph import Graph


def _float0_like(x):
    return np.zeros(x.shape, jax.dtypes.float0)


def sddvv_add(g: Graph, vl: jax.Array, vr: jax.Array) -> jax.Array:
    """Per-edge sum of node scalars: e -> vl[src[e]] + vr[dst[e]].

    The GAT attention-logit kernel (edge_fn = dsl.fn.sum; reference:
    src/codegen/cuda.h:504 `default_function_kernel_sddvv_plus_undir`).
    vl/vr are (n_pad, 1); returns (e_pad,).  Differentiable via XLA's
    gather transpose (a sorted segment sum over src/dst).
    """
    if g.strategy == "spmd":
        from gala_tpu.parallel.ops import spmd_sddvv_add

        return spmd_sddvv_add(g.src, g.dst_local, vl, vr, g.rows_per_shard)
    return vl[g.src, 0] + vr[g.dst, 0]


def sddvv_mul(g: Graph, vl: jax.Array, vr: jax.Array) -> jax.Array:
    """Per-edge product of node scalars: e -> vl[src[e]] * vr[dst[e]].

    The sparsity-aware-rewrite precompute (norm_src * norm_dst edge
    values; reference: src/middle-end/middle-end.h:213-406 emitting
    AGGREGATE_EDGE_MUL_OP, kernel src/codegen/cuda.h:~600 sddvv mult).
    """
    if g.strategy == "spmd":
        from gala_tpu.parallel.ops import spmd_sddvv_mul

        return spmd_sddvv_mul(g.src, g.dst_local, vl, vr, g.rows_per_shard)
    return vl[g.src, 0] * vr[g.dst, 0]


def sddmm(g: Graph, a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-edge dot product: e -> <a[src[e]], b[dst[e]]>.

    Above the gathered-buffer budget the edges run through a rolled
    lax.scan (two bounded (rows, F) gather temps per step instead of two
    (E, F) buffers — 63GB at ogbn-products full scale).
    (reference: src/codegen/cuda.h `...sddmm_mult_undir_shared`.)
    """
    from gala_tpu.ops.spmm import sddmm_edges

    return sddmm_edges(g.src, g.dst, a, b)


def leaky_relu(x: jax.Array, alpha: float = 0.01) -> jax.Array:
    return jnp.where(x > 0, x, alpha * x)


# --------------------------------------------------------------------------- #
# edge softmax: softmax over each destination's incoming-edge segment
# --------------------------------------------------------------------------- #
def _segment_softmax(logits, dst, n_seg):
    m = jax.ops.segment_max(logits, dst, num_segments=n_seg, indices_are_sorted=True)
    # empty segments produce -inf max; make it safe
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    z = jnp.exp(logits - m[dst])
    s = jax.ops.segment_sum(z, dst, num_segments=n_seg, indices_are_sorted=True)
    s = jnp.where(s > 0, s, 1.0)
    return z / s[dst]


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _edge_softmax(n_seg, dst, logits):
    return _segment_softmax(logits, dst, n_seg)


def _edge_softmax_fwd(n_seg, dst, logits):
    p = _segment_softmax(logits, dst, n_seg)
    return p, (dst, p)


def _edge_softmax_bwd(n_seg, res, dp):
    dst, p = res
    # dlogits = p * (dp - sum_over_segment(p * dp))   — exactly the
    # reference's softmax backward `sds - softmax*rowsum(sds)`
    # (reference: src/codegen/common.h:1000-1060).
    sds = jax.ops.segment_sum(p * dp, dst, num_segments=n_seg, indices_are_sorted=True)
    dlogits = p * (dp - sds[dst])
    return (_float0_like(dst), dlogits)


_edge_softmax.defvjp(_edge_softmax_fwd, _edge_softmax_bwd)


def edge_softmax(g: Graph, logits: jax.Array) -> jax.Array:
    """Softmax of edge logits over each destination's neighborhood.

    Padded edges (vals==0 rows) belong to the phantom segment and do not
    affect real nodes.  Forward saves the normalized probabilities as the
    backward residual, matching the reference's softmax autograd.
    """
    if g.strategy == "spmd":
        from gala_tpu.parallel.ops import spmd_edge_softmax

        return spmd_edge_softmax(g.dst_local, logits, g.occ, g.rows_per_shard)
    return _edge_softmax(g.n_pad, g.dst, logits)


def mask_padded_edges(g: Graph, evals: jax.Array) -> jax.Array:
    """Zero out phantom-edge entries of a per-edge vector."""
    e_idx = jnp.arange(g.e_pad)
    return jnp.where(e_idx < g.n_edges, evals, 0.0)
