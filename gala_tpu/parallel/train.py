"""Sharded full-graph training step (SPMD over a device mesh).

Parallelism mapping for GNN training (SURVEY.md §2.4 — none of this
exists in the reference, which is single-GPU only):

- DP  (data)   : nodes range-partitioned over the 'data' axis — features,
                 labels, masks and destination-rows of the adjacency all
                 live with their owner shard.
- SP  (context): the same partition applied to the *edge/contraction*
                 dimension — each shard reduces its own incoming edges;
                 remote source features arrive by all_gather
                 (backward: psum_scatter, inserted by autodiff).
- TP  (model)  : FFN weights column-sharded on layer 1 / row-sharded on
                 layer 2 (Megatron pattern) over the 'model' axis with a
                 psum joining the partial products.
- PP/EP        : not applicable to 2-layer full-graph GNNs (layers are
                 dependent full-graph sweeps; no experts).

The whole step (loss + grads + Adam update) is one jitted SPMD program.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from gala_tpu.parallel.graph import ShardedGraph
from gala_tpu.parallel.ops import spmd_spmm, spmd_spmm_halo


def init_gcn_params(rng, d_in, d_hidden, d_out):
    k1, k2 = jax.random.split(rng)
    lim1 = 1.0 / jnp.sqrt(d_in)
    lim2 = 1.0 / jnp.sqrt(d_hidden)
    return {
        "w1": jax.random.uniform(k1, (d_in, d_hidden), jnp.float32, -lim1, lim1),
        "b1": jnp.zeros((d_hidden,), jnp.float32),
        "w2": jax.random.uniform(k2, (d_hidden, d_out), jnp.float32, -lim2, lim2),
        "b2": jnp.zeros((d_out,), jnp.float32),
    }


def param_specs():
    """TP shardings: col-parallel w1/b1, row-parallel w2, replicated b2."""
    return {
        "w1": P(None, "model"),
        "b1": P("model"),
        "w2": P("model", None),
        "b2": P(),
    }


def make_sharded_train_step(mesh, sg: ShardedGraph, d_in, d_hidden, d_out,
                            lr=0.01, weight_decay=5e-4, halo=False):
    """Returns (params, opt_state, step_fn, fwd_fn) — all jitted SPMD.

    step_fn(params, opt_state, x, y, mask) -> (params, opt_state, loss)
    """
    r = sg.rows_per_shard
    tx = optax.chain(optax.add_decayed_weights(weight_decay), optax.adam(lr))

    graph_spec = ShardedGraph(
        src=P("data"), dst_local=P("data"), vals=P("data"), occ=P("data"),
        deg=P("data"),
        src_halo=P("data"), send_idx=P("data"),
        n_shards=sg.n_shards, rows_per_shard=r, n_pad=sg.n_pad,
        n_nodes=sg.n_nodes, edges_per_shard=sg.edges_per_shard,
        edges_local=sg.edges_local, halo=sg.halo,
        use_halo=sg.use_halo,
    )
    pspecs = param_specs()

    def aggregate(g, h):
        if halo:
            return spmd_spmm_halo(
                g.src_halo, g.dst_local, g.vals, h, g.send_idx,
                r, sg.n_shards, sg.halo, sg.edges_local,
            )
        return spmd_spmm(g.src, g.dst_local, g.vals, h, r)

    def local_forward(params, g, x):
        """Runs per-shard inside shard_map: 2-layer GCN."""
        deg = g.deg
        safe = jnp.where(deg > 0, deg, 1.0)
        norm = jnp.where(deg > 0, jax.lax.rsqrt(safe), 0.0)
        norm = jax.lax.stop_gradient(norm)

        h = norm * x
        h = aggregate(g, h)
        h = h @ params["w1"] + params["b1"]          # cols sharded over 'model'
        h = norm * h
        h = jax.nn.relu(h)

        h = norm * h
        h = aggregate(g, h)
        h = h @ params["w2"]                          # partial over 'model'
        h = jax.lax.psum(h, "model") + params["b2"]
        h = norm * h
        return h

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspecs, graph_spec, P("data"), P("data"), P("data")),
        out_specs=P(),
        check_vma=True,
    )
    def local_loss(params, g, x, y, mask):
        logits = local_forward(params, g, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=-1)[:, 0]
        m = mask.astype(jnp.float32)
        num = jax.lax.psum(jnp.sum(nll * m), "data")
        den = jax.lax.psum(jnp.sum(m), "data")
        return num / jnp.maximum(den, 1.0)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspecs, graph_spec, P("data")),
        out_specs=P("data"),
        check_vma=True,
    )
    def sharded_fwd(params, g, x):
        return local_forward(params, g, x)

    # the graph rides as a jit ARGUMENT, not a closure: a traced
    # closure over a device array is illegal in multi-process runs
    # (the global array spans non-addressable devices — caught by
    # tests/test_multihost.py) and embeds Reddit-scale constants in the
    # lowered module in single-process ones
    @jax.jit
    def _step(params, opt_state, g, x, y, mask):
        loss, grads = jax.value_and_grad(local_loss)(params, g, x, y, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    @jax.jit
    def _fwd(params, g, x):
        return sharded_fwd(params, g, x)

    def step_fn(params, opt_state, x, y, mask):
        return _step(params, opt_state, sg, x, y, mask)

    def fwd_fn(params, x):
        return _fwd(params, sg, x)

    with mesh:
        params = init_gcn_params(jax.random.key(0), d_in, d_hidden, d_out)
        params = jax.device_put(
            params, {k: NamedSharding(mesh, s) for k, s in pspecs.items()}
        )
        opt_state = tx.init(params)
    return params, opt_state, step_fn, fwd_fn
