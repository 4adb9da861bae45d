"""Minibatch GraphSAGE training (neighbor-sampled gather pipeline).

The BASELINE "GraphSAGE with neighbor sampling on Reddit (minibatch
gather/scatter pipeline)" config:

- host: `NeighborSampler` produces an EPOCH of fixed-shape index
  tensors at once (gala_tpu.data.minibatch), vectorized NumPy;
- device: the whole epoch runs as ONE `lax.scan` over batches — each
  batch is three gathers from the device-resident feature table plus
  dense matmuls (mean-aggregate SAGE estimator), so per-dispatch
  overhead is paid once per epoch, not once per batch;
- parameters are SHARED with the full-graph SAGE model
  (gala_tpu.models.sage.init): validation runs the exact full-graph
  forward with the same weights, so minibatch training is measured by
  the same accuracy oracle as everything else.

The sampled mean over `fanout` neighbors is the standard GraphSAGE
estimator of the full mean aggregation (reference's sampling modes:
src/ops/tiling.h:389-512, src/codegen/common.h:822-833).
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gala_tpu.data.csr import HostCSR
from gala_tpu.data.minibatch import NeighborSampler
from gala_tpu.models import sage
from gala_tpu.models.common import linear
from gala_tpu.ops.graph import Graph
from gala_tpu.train import TrainResult, make_optimizer, masked_accuracy


def forward_minibatch(params, xt, t, n1, n2):
    """2-layer mean-aggregate SAGE on a sampled neighborhood.

    xt: (N_pad, F) device feature table; t: (B,), n1: (B, f1),
    n2: (B, f1, f2) sampled indices.  Returns (B, C) logits.
    Weight layout matches gala_tpu.models.sage (fc = neighbor FFN,
    sfc = self FFN; relu between layers, none on the last).
    """
    x_t = xt[t]                                   # (B, F)
    x_n1 = xt[n1]                                 # (B, f1, F)
    x_n2 = xt[n2]                                 # (B, f1, f2, F)
    fc, sfc = params["fc"], params["sfc"]
    h_t = jax.nn.relu(
        linear(fc[0], jnp.mean(x_n1, axis=1)) + linear(sfc[0], x_t)
    )                                             # (B, H)
    h_n1 = jax.nn.relu(
        linear(fc[0], jnp.mean(x_n2, axis=2)) + linear(sfc[0], x_n1)
    )                                             # (B, f1, H)
    return linear(fc[1], jnp.mean(h_n1, axis=1)) + linear(sfc[1], h_t)


def train_sage_minibatch(
    g_host: HostCSR,
    feats: np.ndarray,
    labels: np.ndarray,
    masks: dict,
    fanouts: tuple[int, int] = (25, 10),
    batch_size: int = 512,
    hidden: int = 32,
    iters: int = 10,
    valid_step: int = 2,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    warmup: int = 1,
    seed: int = 0,
    dtype=None,
    dynamic: bool = True,
) -> TrainResult:
    """Train minibatch SAGE; validate full-graph with the same params."""
    n_classes = int(labels.max()) + 1
    g = Graph.from_host(g_host)  # full graph for validation only
    xt = g.pad_nodes(feats)
    if dtype is not None:
        xt = xt.astype(dtype)
    y_pad = g.pad_nodes(labels)
    test_mask = g.pad_nodes(masks["test"])

    params = sage.init(jax.random.key(seed), feats.shape[1], [hidden], n_classes)
    tx = make_optimizer(lr, weight_decay)
    opt_state = tx.init(params)

    sampler = NeighborSampler(g_host, fanouts, batch_size)
    train_nodes = np.flatnonzero(np.asarray(masks["train"]))

    # xt and the validation arrays ride as jit ARGUMENTS, never
    # closures: a closed-over device array is embedded in the lowered
    # module as a constant, and a Reddit-scale feature table blows the
    # remote compile helper's request-size limit (HTTP 413)
    def batch_loss(p, xt, t, n1, n2, yb, mb):
        logits = forward_minibatch(p, xt, t, n1, n2)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, yb[:, None], 1)[:, 0]
        m = mb.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    @jax.jit
    def run_epoch(p, o, xt, batches):
        def body(carry, xs):
            p, o = carry
            t, n1, n2, yb, mb = xs
            loss, grads = jax.value_and_grad(batch_loss)(
                p, xt, t, n1, n2, yb, mb
            )
            updates, o2 = tx.update(grads, o, p)
            return (optax.apply_updates(p, updates), o2), loss

        (p, o), losses = jax.lax.scan(body, (p, o), batches)
        return p, o, jnp.mean(losses)

    @jax.jit
    def full_accuracy(p, g, xt, y_pad, test_mask):
        logits = sage.forward(p, [g, g], xt)
        return masked_accuracy(logits, y_pad, test_mask)

    y_np = np.asarray(labels, np.int64)
    losses, accs = [], []
    t_start = None
    epoch_times = []
    for ep in range(iters):
        eb = sampler.epoch(train_nodes, ep, seed=seed, dynamic=dynamic)
        yb = y_np[eb.targets].astype(np.int32)
        batches = tuple(
            jnp.asarray(a) for a in (eb.targets, eb.n1, eb.n2, yb, eb.mask)
        )
        t0 = time.perf_counter()
        params, opt_state, loss = run_epoch(params, opt_state, xt, batches)
        loss = float(loss)  # the host fetch waits for the epoch
        if ep >= warmup:
            epoch_times.append(time.perf_counter() - t0)
        losses.append(loss)
        if valid_step and ep % valid_step == 0:
            accs.append(float(full_accuracy(params, g, xt, y_pad, test_mask)))
    if valid_step:
        accs.append(float(full_accuracy(params, g, xt, y_pad, test_mask)))
    mean_epoch = float(np.mean(epoch_times)) if epoch_times else 0.0
    return TrainResult(
        params=params,
        losses=losses,
        accuracies=accs,
        inference_time=mean_epoch,
        total_time=mean_epoch,
        max_accuracy=max(accs) if accs else 0.0,
        memory_mb=0.0,
    )
