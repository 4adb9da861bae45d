"""Pipeline parallelism: GPipe schedule over a 'pipe' mesh axis.

The reference has no distributed execution of any kind (its Environment
enum is aspirational — reference: src/codegen/common.h:22-29); SURVEY
§2.4 marks PP optional for 2-layer full-graph GNNs, where there is no
microbatch stream to pipeline.  The stream DOES exist in the minibatch
path (gala_tpu/train_minibatch.py): every epoch is a sequence of
fixed-shape sampled neighborhoods, which is exactly GPipe's input shape.

SPMD design — no per-stage processes, no send/recv runtime:

- one `shard_map` over a ('pipe',) mesh; every device runs the SAME
  traced program (SPMD), so XLA compiles once;
- the schedule is a `lax.scan` over T = n_micro + P - 1 ticks; each
  tick applies the local stage to its activation-in-flight, then one
  `ppermute` ring-shifts activations to the next stage;
- activations are padded to one uniform (B, W) lane width so the
  in-flight buffer has a single static shape (XLA requirement);
- the backward pass is jax.grad THROUGH the scan: ppermute's transpose
  is the reverse shift, so the reverse schedule is derived, not
  hand-written; each stage's parameter gradients materialize only on
  its own device (other stages' slices get structural zeros).

GNN params are KB-scale, so PP here buys compute/comm pipelining, not
parameter-memory relief; per-stage slices of the stacked tree hold
zeros off-stage rather than block-padded shapes (documented tradeoff:
same treedef across stages makes the stacked pytree shardable with a
single P('pipe') spec).

Bubble fraction is GPipe's (P-1)/(n_micro+P-1) — amortized by more
microbatches per epoch, which the one-scan-per-epoch design favors.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_pipe_mesh(n_stages: int) -> Mesh:
    devs = jax.devices()
    if n_stages > len(devs):
        raise ValueError(f"need {n_stages} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n_stages]), axis_names=("pipe",))


def pipe_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("pipe"))


def _ring(p: int):
    return [(i, (i + 1) % p) for i in range(p)]


def stack_stage_params(per_stage: list) -> dict:
    """Stack per-stage pytrees (same treedef + leaf shapes) into one
    tree with leading axis P, shardable with in_specs=P('pipe')."""
    return jax.tree.map(lambda *a: jnp.stack(a), *per_stage)


def gpipe(mesh: Mesh, stage_fn, stage_params, xs, w_out: int):
    """Run a microbatch stream through a P-stage pipeline (forward).

    stage_fn(params_i, h, stage_idx) -> h': the stage body; takes and
        returns (B, W) activations (narrower stages pad to W).
    stage_params: pytree with leading axis P (stage i's slice lives on
        device i of the 'pipe' axis; see stack_stage_params).
    xs: (n_micro, B, W) microbatch stream, consumed by stage 0.
    w_out: number of valid output columns (<= W).

    Returns (n_micro, B, w_out) outputs in microbatch order.
    """
    p = mesh.shape["pipe"]
    n_micro = xs.shape[0]
    t_total = n_micro + p - 1

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("pipe"), P()),
        out_specs=P("pipe"),
        check_vma=False,
    )
    def run(params_sh, xs_rep):
        params_local = jax.tree.map(lambda a: a[0], params_sh)
        idx = jax.lax.axis_index("pipe")

        def tick(state, t):
            # stage 0 ingests microbatch t (clamped; ticks >= n_micro
            # feed it stale data whose outputs are never collected)
            mb = jax.lax.dynamic_index_in_dim(
                xs_rep, jnp.minimum(t, n_micro - 1), keepdims=False
            )
            h_in = jnp.where(idx == 0, mb, state)
            h_out = stage_fn(params_local, h_in, idx)
            state_next = jax.lax.ppermute(h_out, "pipe", _ring(p))
            return state_next, h_out

        init = jnp.zeros(xs_rep.shape[1:], xs_rep.dtype)
        _, emitted = jax.lax.scan(tick, init, jnp.arange(t_total))
        # only the LAST stage's emissions at ticks p-1 .. t_total-1 are
        # finished microbatches; zero the others so the stacked output
        # can be index-selected on the host
        is_last = (idx == p - 1).astype(emitted.dtype)
        return (emitted * is_last)[None]  # per-shard (1, T, B, W)

    out = run(stage_params, xs)  # (P, T, B, W)
    return out[p - 1, p - 1 :, :, :w_out]


# --------------------------------------------------------------------- #
# Concrete wiring: 2-stage minibatch SAGE (one GNN layer per stage).
# Stage 0: feature-table gathers + layer-1 mean-aggregate SAGE; the
# packed (B, (1+f1)*H) activation (h_t | h_n1) ppermutes to stage 1,
# which computes layer-2 logits and the masked loss.  The feature table
# is read-only within an epoch and replicated.
# --------------------------------------------------------------------- #


def make_sage_pipeline(mesh: Mesh, xt, f1: int, hidden: int, n_classes: int,
                       lr: float = 0.01, weight_decay: float = 5e-4,
                       seed: int = 0):
    """Build pipelined 2-stage minibatch-SAGE training.

    Returns (stage_params, opt_state, step) where
    step(stage_params, opt_state, micro) -> (params, opt, mean_loss)
    and micro is a dict of device arrays:
        t (n_micro, B) int32, n1 (n_micro, B, f1) int32,
        n2 (n_micro, B, f1, f2) int32, y (n_micro, B) int32,
        m (n_micro, B) bool/float mask.
    Weight layout matches gala_tpu.models.sage so the trained params
    recombine into the full-graph validation forward
    (merge_sage_params).
    """
    import optax

    from gala_tpu.models import sage
    from gala_tpu.models.common import linear

    p_axis = mesh.shape["pipe"]
    if p_axis != 2:
        raise ValueError("SAGE wiring is 2-stage (one GNN layer per stage)")
    h = hidden
    w_act = (1 + f1) * h
    n_feat = int(xt.shape[1])

    base = sage.init(jax.random.key(seed), n_feat, [hidden], n_classes)
    fc, sfc = base["fc"], base["sfc"]
    zeros_like = lambda t: jax.tree.map(jnp.zeros_like, t)
    # same treedef on both stages; off-stage slices are zeros (see
    # module docstring for the tradeoff)
    s0 = {"l1": {"fc": fc[0], "sfc": sfc[0]},
          "l2": zeros_like({"fc": fc[1], "sfc": sfc[1]})}
    s1 = {"l1": zeros_like({"fc": fc[0], "sfc": sfc[0]}),
          "l2": {"fc": fc[1], "sfc": sfc[1]}}
    stage_params = stack_stage_params([s0, s1])
    stage_params = jax.device_put(stage_params, pipe_sharding(mesh))

    tx = optax.chain(optax.add_decayed_weights(weight_decay), optax.adam(lr))
    opt_state = tx.init(stage_params)

    def stage0(pl, xt, t, n1, n2):
        # xt rides as a shard_map argument: a closed-over device array
        # is embedded in the lowered module as a constant and blows the
        # remote compile helper's request-size limit at Reddit scale
        x_t = xt[t]
        x_n1 = xt[n1]
        x_n2 = xt[n2]
        fc0, sfc0 = pl["l1"]["fc"], pl["l1"]["sfc"]
        h_t = jax.nn.relu(linear(fc0, jnp.mean(x_n1, axis=1)) + linear(sfc0, x_t))
        h_n1 = jax.nn.relu(linear(fc0, jnp.mean(x_n2, axis=2)) + linear(sfc0, x_n1))
        b = t.shape[0]
        return jnp.concatenate([h_t[:, None, :], h_n1], axis=1).reshape(b, w_act)

    def stage1(pl, act):
        b = act.shape[0]
        a = act.reshape(b, 1 + f1, h)
        return linear(pl["l2"]["fc"], jnp.mean(a[:, 1:], axis=1)) + linear(
            pl["l2"]["sfc"], a[:, 0]
        )

    def masked_nll(logits, yb, mb):
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, yb[:, None].astype(jnp.int32), 1)[:, 0]
        m = mb.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("pipe"), P(), P(), P(), P(), P(), P()),
        out_specs=(P("pipe"), P()),
        check_vma=False,
    )
    def pipelined_grads(params_sh, xt_rep, ts, n1s, n2s, ys, ms):
        params_local = jax.tree.map(lambda a: a[0], params_sh)
        idx = jax.lax.axis_index("pipe")
        n_micro = ts.shape[0]
        t_total = n_micro + 1  # P = 2

        def fwd_loss(pl):
            def tick(state, i):
                i0 = jnp.minimum(i, n_micro - 1)      # stage-0 ingest tick
                i1 = jnp.clip(i - 1, 0, n_micro - 1)  # stage-1 emit tick
                t = jax.lax.dynamic_index_in_dim(ts, i0, keepdims=False)
                n1 = jax.lax.dynamic_index_in_dim(n1s, i0, keepdims=False)
                n2 = jax.lax.dynamic_index_in_dim(n2s, i0, keepdims=False)
                yb = jax.lax.dynamic_index_in_dim(ys, i1, keepdims=False)
                mb = jax.lax.dynamic_index_in_dim(ms, i1, keepdims=False)
                # SPMD: both stage bodies trace on every device; `where`
                # and the loss mask select the live one
                act0 = stage0(pl, xt_rep, t, n1, n2)
                logits = stage1(pl, state)
                h_out = jnp.where(idx == 0, act0, jnp.zeros_like(act0))
                state_next = jax.lax.ppermute(h_out, "pipe", _ring(2))
                l = masked_nll(logits, yb, mb)
                l = jnp.where((idx == 1) & (i >= 1), l, 0.0)
                return state_next, l

            init = jnp.zeros((ts.shape[1], w_act), xt_rep.dtype)
            _, losses = jax.lax.scan(tick, init, jnp.arange(t_total))
            # one scalar shared by psum so both stages' grads flow from
            # the same loss; per-stage grads land on their own devices
            return jax.lax.psum(jnp.sum(losses), "pipe") / n_micro

        loss, grads = jax.value_and_grad(fwd_loss)(params_local)
        return jax.tree.map(lambda g: g[None], grads), loss[None]

    @jax.jit
    def step(stage_params, opt_state, micro):
        grads, loss = pipelined_grads(
            stage_params, xt, micro["t"], micro["n1"], micro["n2"],
            micro["y"], micro["m"],
        )
        import optax as _ox

        updates, opt_state2 = tx.update(grads, opt_state, stage_params)
        return _ox.apply_updates(stage_params, updates), opt_state2, loss[0]

    return stage_params, opt_state, step


def merge_sage_params(stage_params) -> dict:
    """Recombine pipelined stage params into the gala_tpu.models.sage
    layout (for full-graph validation with the shared oracle)."""
    host = jax.device_get(stage_params)
    return {
        "fc": [jax.tree.map(lambda a: a[0], host["l1"]["fc"]),
               jax.tree.map(lambda a: a[1], host["l2"]["fc"])],
        "sfc": [jax.tree.map(lambda a: a[0], host["l1"]["sfc"]),
                jax.tree.map(lambda a: a[1], host["l2"]["sfc"])],
    }
