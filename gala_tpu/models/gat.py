"""GAT: additive attention with edge softmax, single- or multi-head.

Layer body as in the reference DSL (reference:
tests/GALA-DSL/gat/Reddit/a100.txt):

    res   = x @ W + b              (FFN)
    attnL = res @ aL  (out=1)      (FFN_OP_EDGE)
    attnR = res @ aR  (out=1)
    attn  = attnL[src] + attnR[dst]        (SDDVV, edge_fn = sum)
    attn  = leaky_relu(attn)               (optional, per DSL)
    vals  = edge_softmax(attn)             (per-destination segments)
    res   = SpMM_with_edge_values(vals, res)
    x     = relu(res)

Multi-head (standard GAT, BASELINE.json configs[2]): each head h owns
its OWN attention vectors aL_h/aR_h of size fh (per-head width); hidden
layers concatenate heads, the final layer averages them.  The fused op
(gala_tpu.ops.attention) aggregates ALL heads with one slot gather.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gala_tpu.models.common import linear, linear_init
from gala_tpu.ops.edge import edge_softmax, leaky_relu, sddvv_add
from gala_tpu.ops.graph import Graph
from gala_tpu.ops.spmm import spmm_ev


def _attn_vec_init(rng: jax.Array, n_heads: int, fh: int):
    """Per-head attention vectors: w (H, fh), b (H,) with the same
    U(-1/sqrt(fan_in)) bound as nn::Linear(fh, 1) per head."""
    kw, kb = jax.random.split(rng)
    bound = 1.0 / jnp.sqrt(jnp.maximum(fh, 1))
    w = jax.random.uniform(kw, (n_heads, fh), jnp.float32, -bound, bound)
    b = jax.random.uniform(kb, (n_heads,), jnp.float32, -bound, bound)
    return {"w": w, "b": b}


def _head_scores(p, res, n_heads):
    """(N, H) per-head scores: score[n, h] = res[n, h*fh:(h+1)*fh] @ w[h] + b[h].
    Contraction over fh with H as a (tiny, static) batch — NOT the
    (n,k,f)x(n,f) shape that lowers to n tiny batched matmuls."""
    n = res.shape[0]
    fh = res.shape[1] // n_heads
    r3 = res.reshape(n, n_heads, fh)
    return (
        jnp.einsum("nhf,hf->nh", r3, p["w"].astype(res.dtype))
        + p["b"].astype(res.dtype)
    )


def init(
    rng: jax.Array,
    n_feats: int,
    hidden: list[int],
    n_classes: int,
    n_heads: int = 1,
):
    """n_heads > 1: per-layer weights become (d_in, H*d_out); hidden
    layers concatenate heads (so the next layer sees H*d_out), the final
    layer averages them (standard GAT; the reference's DSL GAT is the
    H=1 special case).  Attention vectors are PER HEAD: (H, d_out)."""
    dims = [n_feats, *[h * n_heads for h in hidden], n_classes]
    sizes = list(zip(dims[:-1], dims[1:]))
    keys = jax.random.split(rng, 3 * len(sizes)).reshape(len(sizes), 3)
    heads = [n_heads] * len(sizes)
    per_head = [*hidden, n_classes]
    return {
        "fc": [
            linear_init(k[0], i, h * o)
            for k, (i, _), h, o in zip(keys, sizes, heads, per_head)
        ],
        "attn_l": [
            _attn_vec_init(k[1], h, o) for k, h, o in zip(keys, heads, per_head)
        ],
        "attn_r": [
            _attn_vec_init(k[2], h, o) for k, h, o in zip(keys, heads, per_head)
        ],
    }


def forward(
    params,
    graphs: list[Graph],
    x: jax.Array,
    negative_slope: float = 0.2,
    n_heads: int = 1,
):
    # negative_slope 0.2 matches the reference's hardcoded leaky-relu param
    # (reference: src/frontend/frontend.y addLeakyReLU `addParam("0.2")`).
    n_layers = len(params["fc"])
    for li in range(n_layers):
        g = graphs[li]
        res = linear(params["fc"][li], x)          # (N, H*Fh)
        fh = res.shape[1] // n_heads
        attn_l = _head_scores(params["attn_l"][li], res, n_heads)   # (N, H)
        attn_r = _head_scores(params["attn_r"][li], res, n_heads)   # (N, H)
        if g.attn is not None:
            # fused slot-space attention (gala_tpu.ops.attention):
            # ONE gather for all heads instead of the edge-centric chain
            from gala_tpu.ops.attention import attention_aggregate

            res = attention_aggregate(
                g.n_pad, g.c_pad, negative_slope, g.attn, res, attn_l, attn_r
            )
        else:
            h_outs = []
            for h in range(n_heads):
                rh = res[:, h * fh : (h + 1) * fh]
                attn = sddvv_add(
                    g, attn_l[:, h : h + 1], attn_r[:, h : h + 1]
                )
                attn = leaky_relu(attn, negative_slope)
                vals = edge_softmax(g, attn)
                h_outs.append(spmm_ev(g, vals, rh))
            res = jnp.concatenate(h_outs, axis=1) if n_heads > 1 else h_outs[0]
        if li == n_layers - 1 and n_heads > 1:
            # average final-layer heads (standard GAT output combine)
            res = res.reshape(res.shape[0], n_heads, fh).mean(axis=1)
        x = jax.nn.relu(res) if li < n_layers - 1 else res
    return x
