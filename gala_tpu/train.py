"""Training loop: Adam + cross-entropy on the train mask, timed epochs.

Replaces the reference's generated `main()` training loop
(reference: src/codegen/common.h:1474-1587):

- optimizer: Adam(lr=0.01, weight_decay=5e-4) with torch semantics
  (decay added to the gradient before the moment update).
- loss: cross-entropy over train-mask rows only.
- timing: per-epoch forward time and total (fwd+bwd+step) time; the first
  `warmup` epochs are excluded from the means (reference skips 5).
- validation: every `valid_step` epochs the forward pass runs on the full
  graph (graph index 0) and test accuracy is recorded; other epochs may
  run on per-layer training subgraphs (reference: the `ep % mod_v`
  dispatch in src/codegen/common.h:919-925).

Timing protocol (see gala_tpu/utils/timing.py): all epochs of a phase
are dispatched with no host synchronization inside the timed region,
which ends in block_until_ready on what it dispatched.  Per-epoch losses are
stacked on device and fetched once; test accuracy is evaluated after the
timed region on per-validation-epoch parameter snapshots, so accuracy
work never inflates epoch times (the reference computes accuracy between
its timing brackets for the same reason,
reference: src/codegen/common.h:1518-1543).
"""
from __future__ import annotations

import dataclasses
import functools
import os as _os
import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gala_tpu.ops.graph import Graph


def masked_cross_entropy(logits: jax.Array, labels: jax.Array, mask: jax.Array):
    """Mean CE over mask rows (mask includes padding=False rows)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    m = mask.astype(logits.dtype)
    return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)


def masked_accuracy(logits: jax.Array, labels: jax.Array, mask: jax.Array):
    pred = jnp.argmax(logits, axis=-1)
    m = mask.astype(jnp.float32)
    return jnp.sum((pred == labels) * m) / jnp.maximum(jnp.sum(m), 1.0)


def make_optimizer(lr: float = 0.01, weight_decay: float = 5e-4):
    """torch Adam(lr, weight_decay) semantics: L2 added to grads, then Adam
    (NOT decoupled AdamW) — reference: generated `torch::optim::Adam(...,
    .weight_decay(5e-4))` (src/codegen/common.h:1480)."""
    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.adam(lr),
    )


@dataclasses.dataclass
class TrainResult:
    inference_time: float   # mean fwd seconds/epoch (post warmup)
    total_time: float       # mean fwd+bwd+step seconds/epoch
    max_accuracy: float     # max test accuracy over validation epochs
    losses: list
    accuracies: list
    params: object
    memory_mb: float = 0.0
    memory_source: str = ""   # what memory_mb counts (see device_memory_mb)
    # seconds spent building (and running once) every executable before
    # the timed regions: compile time plus one execution of each
    compile_time: float = 0.0

    def csv(self, print_accuracy: bool = False, print_memory: bool = False) -> str:
        """The reference's stdout CSV contract
        (reference: src/codegen/common.h:1571-1587)."""
        if print_memory:
            return f"{self.memory_mb},{self.inference_time},{self.total_time}"
        if print_accuracy:
            return f"{self.inference_time},{self.total_time},{self.max_accuracy}"
        return f"{self.inference_time},{self.total_time}"


def device_memory_mb() -> tuple[float, str]:
    """(MB, source): device memory in use (the cudaMemGetInfo analog,
    reference: src/codegen/cuda.h:1000-1008).

    source is "bytes_in_use" where the backend reports memory_stats (the
    GPU); otherwise (the CPU backend) it is "live_array_logical_bytes",
    the summed logical size of the live jax.Arrays."""
    stats = jax.devices()[0].memory_stats()
    if stats and "bytes_in_use" in stats:
        return float(stats["bytes_in_use"]) / 1e6, "bytes_in_use"
    total = sum(a.size * a.dtype.itemsize for a in jax.live_arrays())
    return float(total) / 1e6, "live_array_logical_bytes"


def train(
    forward: Callable,
    params,
    full_graphs: Sequence[Graph],
    x: jax.Array,
    labels: jax.Array,
    train_mask: jax.Array,
    test_mask: jax.Array,
    iters: int = 100,
    valid_step: int = 5,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    warmup: int = 5,
    train_graphs: Sequence[Graph] | None = None,
    invariant: Callable | None = None,
    measure_memory: bool = False,
    epoch_inputs: Callable | None = None,
    checkpoint_path: str | None = None,
    resume_from: str | None = None,
    forward_rows: Callable | None = None,
    train_rows: jax.Array | None = None,
    test_rows: jax.Array | None = None,
) -> TrainResult:
    """Run the full training protocol and return timing/accuracy stats.

    forward(params, graphs, x) -> logits (n_pad, n_classes)
    invariant: optional hoisted prefix fn(graphs, x) -> x' run once outside
        the loop (training-invariant code motion product).
    train_graphs: per-layer training subgraphs; when given, non-validation
        epochs aggregate over them instead of the full graph.
    checkpoint_path: save final params + optimizer state there (the
        reference has no checkpointing; see gala_tpu.checkpoint).
    resume_from: restore params + optimizer state before training.
    """
    tx = make_optimizer(lr, weight_decay)
    opt_state = tx.init(params)

    if resume_from:
        from gala_tpu.checkpoint import load_checkpoint

        state = load_checkpoint(
            resume_from,
            like={"params": params, "opt_state": opt_state, "step": 0},
        )
        like = {"params": params, "opt_state": opt_state}
        restored = jax.tree_util.tree_map(
            lambda l, s: jnp.asarray(s, getattr(l, "dtype", None)),
            like, {"params": state["params"], "opt_state": state["opt_state"]},
        )
        params, opt_state = restored["params"], restored["opt_state"]

    if invariant is not None:
        x_train = jax.jit(invariant)(
            train_graphs if train_graphs is not None else full_graphs, x
        )
        x_full = (
            jax.jit(invariant)(full_graphs, x)
            if train_graphs is not None
            else x_train
        )
    else:
        x_train = x_full = x

    use_sub = train_graphs is not None

    def _with_extra(carry, extra):
        if extra and isinstance(carry, dict):
            return {**carry, **extra}
        return carry

    # graphs and features are jit ARGUMENTS, never closures: closed-over
    # device arrays become captured constants embedded in every
    # executable (compile time and memory grow with the graph)
    gs_train = train_graphs if use_sub else full_graphs
    x_train_eff = x_train if use_sub else x_full

    @jax.jit
    def fwd_any(params, graphs, xc, extra):
        return forward(params, graphs, _with_extra(xc, extra))

    def fwd_full(params, extra):
        return fwd_any(params, full_graphs, x_full, extra)

    # Row-index vectors: compile-time CONSTANTS below the size gate,
    # jit arguments above it.  Embedded as literals they let XLA
    # specialize the row-subset gathers (dynamic arguments were slower
    # on the Arxiv headline where the gate was first tuned; not yet
    # measured on the GPU); but at papers100M scale every executable's
    # n-scaled constant copy OOMs during lowering, so giant graphs keep
    # them as arguments — the graphs/features rule.
    _rows_gate = int(
        _os.environ.get("GALA_ROWS_ARGS_MIN_N", str(2_000_000))
    )
    rows_as_args = int(labels.shape[0]) >= _rows_gate
    # numpy (host) constants: traced as literals without the device
    # round-trip that made closed-over jax.Arrays expensive to lower
    train_rows_const = (
        None if (rows_as_args or train_rows is None)
        else np.asarray(train_rows)
    )
    train_rows_arg = train_rows if rows_as_args else None

    if forward_rows is not None and train_rows is not None:
        # training loss on the train-row subset only (classifier +
        # logits at mask-fraction size; see interp.make_forward)
        def _loss(params, graphs, xc, y, tm, extra, rows):
            rows = rows if rows is not None else train_rows_const
            lg = forward_rows(params, graphs, _with_extra(xc, extra), rows)
            return masked_cross_entropy(lg, y[rows], tm[rows])
    else:
        def _loss(params, graphs, xc, y, tm, extra, rows):
            del rows
            return masked_cross_entropy(
                forward(params, graphs, _with_extra(xc, extra)), y, tm
            )

    @jax.jit
    def step_any(params, opt_state, graphs, xc, y, tm, extra, rows):
        loss, grads = jax.value_and_grad(_loss)(
            params, graphs, xc, y, tm, extra, rows
        )
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    def step_full(params, opt_state, extra):
        return step_any(
            params, opt_state, full_graphs, x_full, labels, train_mask,
            extra, train_rows_arg,
        )

    # ---- fused epoch runs: a lax.scan of training steps per dispatch.
    # Each dispatch carries a fixed host cost that matters at
    # millisecond epochs, so the runs of non-validation epochs between
    # validation points are executed as one scanned program (the
    # equivalent of the reference's single generated epoch loop).  Per-epoch inputs
    # (dynamic-sampling (ra, rb), reference: src/codegen/common.h:822-833)
    # do NOT break fusion: they are precomputed for every epoch before
    # the timed region, stacked per chunk, and scanned over as xs —
    # creating them inside the timed loop would both force
    # single-dispatch epochs (measured 8.8x on table7) and starve the
    # in-order stream with per-dispatch H2D transfers.

    @functools.lru_cache(maxsize=None)
    def multi_step(length: int):
        @functools.partial(jax.jit, static_argnums=())
        def run(params, opt_state, graphs, xc, y, tm, extras, rows):
            def body(carry, ex):
                p, o = carry
                loss, grads = jax.value_and_grad(_loss)(
                    p, graphs, xc, y, tm, ex if ex is not None else {}, rows
                )
                updates, o2 = tx.update(grads, o, p)
                return (optax.apply_updates(p, updates), o2), loss

            (p, o), ls = jax.lax.scan(
                body, (params, opt_state), extras, length=length
            )
            return p, o, ls

        def call(params, opt_state, extras=None):
            return run(
                params, opt_state, gs_train, x_train_eff, labels, train_mask,
                extras, train_rows_arg,
            )

        return call

    if forward_rows is not None and test_rows is not None:
        # validation accuracy on the test-row subset only: the
        # classifier FFN + (N, C) logits shrink to the mask fraction —
        # the biggest non-graph buffers at papers100M scale (same
        # row-local suffix selection as the train loss)
        test_rows_const = None if rows_as_args else np.asarray(test_rows)

        @jax.jit
        def _acc_rows(params, graphs, xc, extra, rows, y, sm):
            rows = rows if rows is not None else test_rows_const
            lg = forward_rows(params, graphs, _with_extra(xc, extra), rows)
            return masked_accuracy(lg, y[rows], sm[rows])

        def test_acc(params, extra):
            return _acc_rows(
                params, full_graphs, x_full, extra,
                test_rows if rows_as_args else None, labels, test_mask,
            )
    else:
        @jax.jit
        def _acc_any(params, graphs, xc, y, sm, extra):
            return masked_accuracy(
                forward(params, graphs, _with_extra(xc, extra)), y, sm
            )

        def test_acc(params, extra):
            return _acc_any(params, full_graphs, x_full, labels, test_mask, extra)

    from gala_tpu.utils.timing import EpochTimer

    # per-epoch inputs materialized ON DEVICE before any timed region:
    # nothing inside the timed loops creates device values (a host-to-
    # device copy per dispatch stalls the stream between dispatches)
    all_extras = (
        [epoch_inputs(e) for e in range(iters)] if epoch_inputs else None
    )

    def _extras_stack(start: int, length: int):
        if all_extras is None:
            return None
        keys = all_extras[start].keys()
        return {
            k: jnp.stack([all_extras[start + i][k] for i in range(length)])
            for k in keys
        }

    def epoch_extra(epoch):
        return all_extras[epoch] if all_extras else {}

    def chunk_plan():
        """Epoch schedule as ('single', epoch) / ('chunk', start, length)
        items: the validation epochs run single, on the full graph; the
        runs between them are chunks on the training graphs, which never
        cross the warmup boundary (the timer starts there)."""
        plan = []
        e = 0
        while e < iters:
            is_valid = valid_step > 0 and (e % valid_step == 0)
            if is_valid:
                plan.append(("single", e, 1))
                e += 1
            else:
                nxt = ((e // valid_step) + 1) * valid_step if valid_step > 0 else iters
                end = min(iters, nxt, warmup if e < warmup else iters)
                plan.append(("chunk", e, end - e))
                e = end
        return plan

    plan = chunk_plan()
    chunk_lengths = sorted({ln for kind, _, ln in plan if kind == "chunk"})
    # chunk extras stacked on device BEFORE the timed regions
    chunk_extras = {
        (start, ln): _extras_stack(start, ln)
        for kind, start, ln in plan
        if kind == "chunk"
    }

    @functools.lru_cache(maxsize=None)
    def multi_fwd(length: int):
        @jax.jit
        def run(params, dep0, graphs, xc, extras):
            def body(dep, ex):
                # thread a tiny dependency through EVERY float input —
                # params AND the carried features — so XLA cannot hoist
                # any part of the loop-invariant forward out of the
                # scan.  Threading only the first param leaf left
                # PARAM-FREE PREFIXES hoistable: XLA lifted a 256-wide
                # aggregation sweep out of the scanned inference epochs,
                # and a scanned epoch then read about half a
                # single-dispatch forward.  The term underflows against
                # any real value, so results are unchanged.
                eps = dep * 1e-38

                def bump(v):
                    if hasattr(v, "dtype") and jnp.issubdtype(
                        v.dtype, jnp.floating
                    ):
                        return v + eps.astype(v.dtype)
                    return v

                p = jax.tree_util.tree_map(bump, params)
                xb = jax.tree_util.tree_map(bump, xc)
                lg = forward(p, graphs, _with_extra(xb, ex if ex is not None else {}))
                return jnp.mean(lg).astype(jnp.float32), None

            dep, _ = jax.lax.scan(body, dep0, extras, length=length)
            return dep

        def call(params, dep0, extras=None):
            return run(params, dep0, gs_train, x_train_eff, extras)

        return call

    # ---- compile warmup: build (and run once) every executable the
    # timed regions use, one after another: XLA:GPU autotunes on the
    # device while it compiles, so concurrent builds would contend for
    # the card's memory ----------------------------------------------- #
    extra0 = all_extras[0] if all_extras else {}

    def _stack_like(ln):
        return _extras_stack(0, ln) if all_extras else None

    jobs = []
    if valid_step > 0:
        jobs += [
            lambda: step_full(params, opt_state, extra0),
            lambda: fwd_full(params, extra0),
            lambda: test_acc(params, extra0),
        ]
    for ln in chunk_lengths:
        jobs.append(lambda ln=ln: multi_step(ln)(params, opt_state, _stack_like(ln)))
        jobs.append(lambda ln=ln: multi_fwd(ln)(params, jnp.float32(0.0), _stack_like(ln)))
    t_compile = time.perf_counter()
    for job in jobs:
        jax.block_until_ready(job())
    compile_time = time.perf_counter() - t_compile

    losses, snapshots = [], []
    mem_mb, mem_source = 0.0, ""
    timer = EpochTimer()

    # ---- training phase: dispatch every epoch (validation epochs as
    # single steps, runs between them as one scanned program); wait
    # only at the warmup boundary and at the end. Each step consumes
    # the previous step's parameters, so the last outputs complete last.
    loss = None
    for kind, epoch, ln in plan:
        if epoch == warmup:
            timer.start((params, loss))
            if measure_memory:
                mem_mb, mem_source = device_memory_mb()
        if kind == "single":
            extra = epoch_extra(epoch)
            params, opt_state, loss = step_full(params, opt_state, extra)
            losses.append(loss)
            # parameter snapshot (immutable device arrays, no copy);
            # accuracy is evaluated after the timed region
            snapshots.append((params, extra))
        else:
            params, opt_state, loss = multi_step(ln)(
                params, opt_state, chunk_extras.get((epoch, ln))
            )
            losses.append(loss)  # (ln,) per-epoch losses
    total_time = timer.stop((params, opt_state, loss), n=max(iters - warmup, 1))

    # ---- inference phase: forward-only epochs, same graph schedule.
    # The epochs are independent of each other, so the window waits on
    # every result it dispatched ------------------------------------- #
    outs = []
    # one device scalar reused by every chunk dispatch: creating it per
    # call is a host-to-device copy between dispatches
    _zero = jnp.float32(0.0)
    for kind, epoch, ln in plan:
        if epoch == warmup:
            timer.start(outs)
            outs = []
        if kind == "single":
            outs.append(fwd_full(params, epoch_extra(epoch)))
        else:
            outs.append(
                multi_fwd(ln)(params, _zero, chunk_extras.get((epoch, ln)))
            )
    inference_time = timer.stop(outs, n=max(iters - warmup, 1))

    # ---- deferred metrics (outside both timed regions) -------------- #
    losses_host = np.asarray(
        jnp.concatenate([jnp.atleast_1d(l) for l in losses])
    ).tolist()
    accs = [test_acc(p, e) for p, e in snapshots]
    accs = np.asarray(jnp.stack(accs)).tolist() if accs else []

    if checkpoint_path:
        from gala_tpu.checkpoint import save_checkpoint

        save_checkpoint(checkpoint_path, params, opt_state, step=iters)

    return TrainResult(
        inference_time=inference_time,
        total_time=total_time,
        max_accuracy=float(np.max(accs)) if accs else 0.0,
        losses=losses_host,
        accuracies=accs,
        params=params,
        memory_mb=mem_mb,
        memory_source=mem_source,
        compile_time=compile_time,
    )
