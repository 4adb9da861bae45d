"""Benchmark entry point — prints ONE JSON line (plus an optional
enriched second line when the wall-clock budget allows).

Metric: full-graph GCN training throughput in edges/second (per-epoch
aggregated edges / mean epoch time, the reference's timing protocol:
mean over epochs after a 5-epoch warmup, reference:
src/codegen/common.h:1494-1587).

vs_baseline: ratio against a DGL-equivalent XLA baseline implementing the
same model with naive (unfused, gather/scatter autodiff) ops — the
stand-in for the reference's DGL comparison until real GALA numbers can
be produced on shared hardware (the repo publishes none, BASELINE.md).

Runs on an NVIDIA GPU only: without one it exits non-zero.  Every line
names the device (platform, device_kind, count) and the card's name and
power limit as nvidia-smi reports them.  The headline prints the moment
the two core sections (compiled GCN + naive baseline) finish; the extras
(BCOO baseline, GAT, Products-0.25, RGG2D) run only while the elapsed
wall-clock is under GALA_BENCH_BUDGET_S (default 900 s) and append a
second, enriched line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_T0 = time.time()
BUDGET_S = float(os.environ.get("GALA_BENCH_BUDGET_S", "900"))

import jax
import jax.numpy as jnp
import numpy as np


def _baseline_forward(params, a_indices, a_vals, n, x):
    """DGL-style naive path: autodiff scatter/gather, no transpose-graph
    routing, no invariant hoisting — what the reference baselines do."""
    src, dst = a_indices
    deg = jax.ops.segment_sum(jnp.ones_like(a_vals), dst, num_segments=n)
    norm = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1.0)), 0.0)[:, None]
    h = x
    for li, p in enumerate(params["fc"]):
        h = norm * h
        msg = a_vals[:, None] * h[src]
        h = jax.ops.segment_sum(msg, dst, num_segments=n)
        h = h @ p["w"] + p["b"]
        h = norm * h
        if li == 0:
            h = jax.nn.relu(h)
    return h


def main():
    import argparse

    import optax

    from gala_tpu.data.datasets import load_dataset
    from gala_tpu.dsl.parser import parse_source
    from gala_tpu.lowering.lower import lower
    from __graft_entry__ import GCN_DSL

    ap = argparse.ArgumentParser()
    # one dtype applied to BOTH the compiled path and the naive baseline,
    # so vs_baseline isolates compiler quality from precision choice
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    args = ap.parse_args()
    act_dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found {devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]

    # Arxiv-shaped graph (169k nodes, 1.17M edges, 128 feats, 40 classes)
    data = load_dataset("Arxiv", scale=1.0)
    g_host, feats, labels, masks = data
    n_edges = g_host.n_edges
    iters, warmup = 30, 5

    # ---- core section 1: gala_tpu compiled path ------------------------ #
    spec = parse_source(GCN_DSL)
    # bf16 activations with f32 params/loss; accuracy parity is asserted
    # in tests and the verify flow
    cm = lower(spec, mode="train", data=data, dtype=act_dtype)
    # mean ± std over 3 independent timed runs, so that single-run
    # deltas inside the spread are never read as regressions (reference
    # protocol analog: calc_mean_std, tests/common.h:584-632)
    runs = [
        cm.train(iters=iters, warmup=warmup).total_time for _ in range(3)
    ]
    gala_epoch = float(np.mean(runs))
    gala_std_pct = (
        100.0 * float(np.std(runs)) / gala_epoch if gala_epoch else 0.0
    )

    # ---- core section 2: naive baseline path --------------------------- #
    n = g_host.n_rows
    src = jnp.asarray(g_host.src.astype(np.int32))
    dst = jnp.asarray(g_host.dst.astype(np.int32))
    vals = jnp.asarray(g_host.vals)
    x = jnp.asarray(feats).astype(act_dtype)
    y = jnp.asarray(labels)
    tm = jnp.asarray(masks["train"])
    rng = jax.random.key(0)
    k1, k2 = jax.random.split(rng)
    f, h, c = feats.shape[1], 32, int(labels.max()) + 1
    params = {
        "fc": [
            {"w": jax.random.uniform(k1, (f, h), jnp.float32, -1 / f**0.5, 1 / f**0.5),
             "b": jnp.zeros((h,))},
            {"w": jax.random.uniform(k2, (h, c), jnp.float32, -1 / h**0.5, 1 / h**0.5),
             "b": jnp.zeros((c,))},
        ]
    }
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(0.01))
    opt_state = tx.init(params)

    @jax.jit
    def base_step(params, opt_state):
        def loss_fn(p):
            logits = _baseline_forward(p, (src, dst), vals, n, x)
            logp = jax.nn.log_softmax(logits)
            nll = -jnp.take_along_axis(logp, y[:, None], 1)[:, 0]
            m = tm.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    from gala_tpu.utils.timing import EpochTimer

    timer = EpochTimer()
    loss = None
    for i in range(iters):
        if i == warmup:
            timer.start((params, loss))
        params, opt_state, loss = base_step(params, opt_state)
    base_epoch = timer.stop((params, opt_state, loss), n=iters - warmup)

    headline = {
        "metric": "gcn_arxiv_train_edges_per_s",
        "value": n_edges / gala_epoch,
        "unit": "edges/s",
        "vs_baseline": base_epoch / gala_epoch,
        "dtype": args.dtype,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
        "std_pct": gala_std_pct,
        "runs": len(runs),
    }
    # CONTRACT: the headline prints NOW — everything below is optional.
    print(json.dumps(headline), flush=True)

    if time.time() - _T0 > BUDGET_S:
        return

    # ---- extra 1: stock-library baseline: jax.experimental.sparse ------ #
    # The same GCN written the way a plain-JAX user would: adjacency as a
    # BCOO matrix, aggregation as `A @ X`.  Unlike the hand-written naive
    # baseline above, this code is not ours — it is what the ecosystem
    # ships — so vs_bcoo is a non-self-authored comparison point
    # (reference analog: the DGL/SeaStar/SparseTIR external baselines,
    # tests/Baselines/**).
    from jax.experimental import sparse as jsparse

    a_bcoo = jsparse.BCOO(
        (vals.astype(act_dtype), jnp.stack([dst, src], axis=1)), shape=(n, n)
    )

    def _bcoo_forward(p, h):
        deg = jax.ops.segment_sum(jnp.ones_like(vals), dst, num_segments=n)
        norm = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1.0)), 0.0)
        norm = norm[:, None].astype(h.dtype)
        for li, layer in enumerate(p["fc"]):
            h = norm * h
            h = a_bcoo @ h
            h = h @ layer["w"] + layer["b"]
            h = norm * h
            if li == 0:
                h = jax.nn.relu(h)
        return h

    params_b = jax.tree.map(lambda a: a, params)  # fresh copy, same init
    opt_state_b = tx.init(params_b)

    @jax.jit
    def bcoo_step(params, opt_state):
        def loss_fn(p):
            logits = _bcoo_forward(p, x)
            logp = jax.nn.log_softmax(logits)
            nll = -jnp.take_along_axis(logp, y[:, None], 1)[:, 0]
            m = tm.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    timer_b = EpochTimer()
    loss_b = None
    for i in range(iters):
        if i == warmup:
            timer_b.start((params_b, loss_b))
        params_b, opt_state_b, loss_b = bcoo_step(params_b, opt_state_b)
    bcoo_epoch = timer_b.stop((params_b, opt_state_b, loss_b), n=iters - warmup)

    enriched = dict(headline, vs_bcoo=bcoo_epoch / gala_epoch)

    if time.time() - _T0 > BUDGET_S:
        print(json.dumps(enriched), flush=True)
        return

    # ---- extra 2: second model row: GAT (same dataset/protocol) -------- #
    from __graft_entry__ import GAT_DSL

    cm_gat = lower(parse_source(GAT_DSL), mode="train", data=data,
                   dtype=act_dtype)
    gat_epoch = cm_gat.train(iters=iters, warmup=warmup).total_time
    enriched.update(
        gat_edges_per_s=n_edges / gat_epoch,
        gat_vs_gcn_epoch=gat_epoch / gala_epoch,
    )
    del cm_gat

    # ---- extras 3-4: larger graphs, GCN, same protocol ----------------- #
    # Products-0.25 (R-MAT community stand-in, 617k nodes, 31M edges) and
    # RGG2D (geometric graph with spatial-tile ids, 1.5M nodes, 24M
    # edges: the locality-bearing layout)
    for key, name, scale in (("products", "Products", 0.25),
                             ("rgg", "RGG2D", 1.0)):
        if time.time() - _T0 > BUDGET_S:
            break
        data_x = load_dataset(name, scale=scale)
        cm_x = lower(spec, mode="train", data=data_x, dtype=act_dtype)
        epoch = cm_x.train(iters=15, warmup=3).total_time
        enriched[f"{key}_edges_per_s"] = data_x[0].n_edges / epoch
        # free the graph tables before the next, larger section
        del cm_x, data_x

    print(json.dumps(enriched), flush=True)


if __name__ == "__main__":
    main()
