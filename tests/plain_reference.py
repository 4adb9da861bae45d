"""Plain float32 references for the aggregation executors and the models.

Written with jax.numpy and jax.ops.segment_* only, independently of
gala_tpu.ops: an edge list (src -> dst) in, logits out.  The CPU tests
check them against the compiled GCN and GAT at small size; the GPU tests
(tests/test_gpu.py) check the bell SpMM and the fused attention against
them at Arxiv widths.  Callers set jax.default_matmul_precision.
"""
import jax
import jax.numpy as jnp

SLOPE = 0.2  # leaky-relu slope of the reference's GAT


def spmm(src, dst, vals, x, n):
    """out[d] = sum over edges e with dst[e] == d of vals[e] * x[src[e]]."""
    return jax.ops.segment_sum(vals[:, None] * x[src], dst, num_segments=n)


def edge_softmax_aggregate(src, dst, x, vl, vr, n, slope=SLOPE):
    """Single-head attention: score(e) = leaky_relu(vl[src] + vr[dst]),
    softmax over each destination's in-edges, then the weighted sum of
    x[src].  vl, vr: (n, 1)."""
    z = vl[src, 0] + vr[dst, 0]
    z = jnp.where(z > 0, z, slope * z)
    zmax = jax.ops.segment_max(z, dst, num_segments=n)
    p = jnp.exp(z - zmax[dst])
    denom = jax.ops.segment_sum(p, dst, num_segments=n)
    alpha = p / denom[dst]
    return jax.ops.segment_sum(alpha[:, None] * x[src], dst, num_segments=n)


def _ffn(p, h):
    return h @ p["w"] + p["b"]


def gcn_logits(params, src, dst, vals, x, n):
    """GCN of __graft_entry__.GCN_DSL / examples/gcn.txt: per layer
    norm * (A @ (norm * h)) @ W + b with norm = in_degree^-1/2, ReLU
    between layers.  params: {'weight1': {'w', 'b'}, 'weight2': ...}."""
    deg = jax.ops.segment_sum(jnp.ones_like(vals), dst, num_segments=n)
    norm = jnp.where(deg > 0, deg, 1.0) ** -0.5
    norm = jnp.where(deg > 0, norm, 0.0)[:, None]
    h = x
    n_layers = len(params)
    for li in range(n_layers):
        h = spmm(src, dst, vals, norm * h, n)
        h = norm * _ffn(params[f"weight{li + 1}"], h)
        if li < n_layers - 1:
            h = jax.nn.relu(h)
    return h


def gat_logits(params, src, dst, x, n):
    """Single-head GAT of __graft_entry__.GAT_DSL: per layer
    h W + b, scores from two width-1 FFNs, edge softmax, aggregation,
    ReLU between layers.  params: {'weightL': ..., 'attenLWeightL': ...,
    'attenRWeightL': ...} for L = 1, 2."""
    h = x
    n_layers = sum(k.startswith("weight") for k in params)
    for li in range(1, n_layers + 1):
        res = _ffn(params[f"weight{li}"], h)
        vl = _ffn(params[f"attenLWeight{li}"], res)
        vr = _ffn(params[f"attenRWeight{li}"], res)
        h = edge_softmax_aggregate(src, dst, res, vl, vr, n)
        if li < n_layers:
            h = jax.nn.relu(h)
    return h
