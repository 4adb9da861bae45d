"""IR interpretation: Program -> pure-JAX callables.

This is the codegen stage.  Where the reference emits CUDA/libtorch text
(reference: src/codegen/common.h `generateOpCode`, cuda.h kernel strings)
that nvcc compiles, here each ComputeNode maps to a JAX op and **XLA is
the compiler**: the returned `forward` is traced once under `jax.jit`,
fused, and scheduled by XLA — the role the reference's generated
`gala.cu` plays.

Contract (shared with gala_tpu.train.train):
    init_params(rng, dim_env)            -> params pytree
    invariant(graphs, x)                 -> carry (hoisted tensors)
    forward(params, graphs, carry)       -> logits (n_pad, n_classes)

The hoisted pre-loop section (training-invariant code motion product) is
evaluated once per graph set; its outputs ride in `carry`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gala_tpu.ir.compute_ir import CompOpt, ComputeNode, ComputeOp, OpType, Program
from gala_tpu.ir.data_ir import DataFormat, SYM_CLASSES, SYM_FEATS, SYM_NODES
from gala_tpu.models.common import linear, linear_init
from gala_tpu.ops.edge import edge_softmax, leaky_relu, sddvv_add, sddvv_mul
from gala_tpu.ops.graph import Graph
from gala_tpu.ops.spmm import spmm, spmm_direct, spmm_ev, spmm_sampled


def _resolve(dim: int, dim_env: dict[int, int]) -> int:
    return dim_env.get(dim, dim) if dim < 0 else dim


def param_specs(prog: Program) -> list[tuple[str, str, tuple[int, int], int]]:
    """(kind, name, (rows, cols), layer) for every learned tensor."""
    specs = []
    seen = set()
    for node in prog.all_nodes():
        if node.op in (ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF,
                   ComputeOp.FFN_REPEAT):
            w = node.inputs[1]
            if w.name not in seen:
                seen.add(w.name)
                specs.append(("linear", w.name, (w.rows, w.cols), node.layer))
        elif node.op is ComputeOp.SCALAR_ADD_EPS_MULTIPLY:
            name = f"eps{node.layer + 1}"
            if name not in seen:
                seen.add(name)
                specs.append(("eps", name, (1, 1), node.layer))
    return specs


def make_init_params(prog: Program):
    specs = param_specs(prog)

    def init_params(rng: jax.Array, dim_env: dict[int, int]):
        params = {}
        keys = jax.random.split(rng, max(len(specs), 1))
        for key, (kind, name, (r, c), _layer) in zip(keys, specs):
            if kind == "linear":
                params[name] = linear_init(key, _resolve(r, dim_env), _resolve(c, dim_env))
            else:
                # learned epsilon, init 0 (torch registers eps=0 scalars)
                params[name] = jnp.zeros((), jnp.float32)
        return params

    return init_params


def _graph_for(node: ComputeNode, graphs) -> Graph:
    li = node.layer
    if 0 <= li < len(graphs):
        return graphs[li]
    return graphs[0]


def _eval_node(node: ComputeNode, env, params, graphs):
    # strict input resolution: every data input must be in the env except
    # structural graph arguments (routed via _graph_for) and weight
    # placeholders (routed via params) — a mis-wired IR raises here
    # instead of surfacing as silently-wrong arity downstream
    ins = []
    for d in node.inputs:
        if d.uid in env:
            ins.append(env[d.uid])
        elif d.is_graph or d.fmt is DataFormat.CM:
            continue
        else:
            raise KeyError(
                f"unresolved input '{d.name}' (uid {d.uid}) of op {node.op} "
                f"— IR wiring bug (producer missing or not exported)"
            )
    op = node.op

    # node-sized constants: per-shard rows inside shard_map (SPMD graphs
    # expose local_rows), the padded node count otherwise
    n_rows = getattr(graphs[0], "local_rows", None) or graphs[0].n_pad
    if op is ComputeOp.ONES:
        return jnp.ones((n_rows, 1), jnp.float32)
    if op is ComputeOp.FULL:
        return jnp.full((n_rows, 1), float(node.params[0]), jnp.float32)
    if op is ComputeOp.AGGREGATE_MUL_SUM_DIRECT:
        return spmm_direct(_graph_for(node, graphs), ins[0])
    if op is ComputeOp.POWER:
        p = float(node.params[0])
        x = ins[0]
        safe = jnp.where(x > 0, x, 1.0)
        # detached, zero on padding rows (reference: pow(deg, v).detach())
        return jax.lax.stop_gradient(jnp.where(x > 0, jnp.power(safe, p), 0.0))
    if op is ComputeOp.ROW_BROADCAST:
        return ins[0].astype(ins[1].dtype) * ins[1]
    if op is ComputeOp.AGGREGATE_MUL_SUM:
        g = _graph_for(node, graphs)
        if len(node.inputs) >= 3:  # [feats, graph, edge_vals]
            return spmm_ev(g, env[node.inputs[2].uid], ins[0])
        k_dyn = node.get_opt(CompOpt.SAMPLE_DYNAMIC)
        if k_dyn:
            # per-epoch (ra, rb) arrive through the carry; static kernel
            # sampling was lowered to a data-level resample in lower()
            ra = env.get("_ra", jnp.int32(5))
            rb = env.get("_rb", jnp.int32(7))
            return spmm_sampled(g, ins[0], int(k_dyn), ra, rb)
        return spmm(g, ins[0])
    if op is ComputeOp.FUSED_ATTENTION:
        g = _graph_for(node, graphs)
        x, vl, vr = ins[0], ins[1], ins[2]
        slope = float(node.params[0]) if node.params else 0.2
        if g.strategy == "spmd":
            # sharded fused path: one [x|vl] exchange serves scores and
            # aggregation (gala_tpu.parallel.ops.spmd_attention)
            from gala_tpu.parallel.ops import spmd_attention

            return spmd_attention(g, x, vl, vr, slope)
        if g.attn is not None:
            from gala_tpu.ops.attention import attention_aggregate

            return attention_aggregate(g.n_pad, g.c_pad, slope, g.attn, x, vl, vr)
        # unfused fallback (graph built without the attention layout)
        logits = leaky_relu(sddvv_add(g, vl, vr), slope)
        return spmm_ev(g, edge_softmax(g, logits), x)
    if op is ComputeOp.AGGREGATE_EDGE_SUM:
        return sddvv_add(_graph_for(node, graphs), ins[0], ins[1])
    if op is ComputeOp.AGGREGATE_EDGE_MUL:
        g = _graph_for(node, graphs)
        # structural vals mask padding (and carry weights when weighted)
        return sddvv_mul(g, ins[0], ins[1]) * g.vals
    if op is ComputeOp.SOFTMAX and node.op_type is OpType.UPDATE_EDGE:
        return edge_softmax(_graph_for(node, graphs), ins[0])
    if op is ComputeOp.LEAKY_RELU:
        slope = float(node.params[0]) if node.params else 0.2
        return leaky_relu(ins[0], slope)
    if op is ComputeOp.RELU:
        return jax.nn.relu(ins[0])
    if op in (ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF,
              ComputeOp.FFN_REPEAT):
        w = node.inputs[1]
        plan = getattr(graphs[0], "tp_plan", None)
        if plan and dict(plan).get(w.name) == "row":
            from gala_tpu.parallel.tp import MODEL_AXIS
            # TP row-split closing matmul: each model shard holds a
            # feature-slice of the input and the matching weight rows;
            # one psum restores replication, bias added once
            from gala_tpu.models.common import MATMUL_PRECISION

            p = params[w.name]
            x_in = ins[0]
            part = jnp.dot(
                x_in, p["w"].astype(x_in.dtype),
                preferred_element_type=x_in.dtype,
                precision=MATMUL_PRECISION,
            )
            return jax.lax.psum(part, MODEL_AXIS) + p["b"].astype(x_in.dtype)
        # replicated or TP col-split: the weight arrives pre-split, the
        # local matmul needs no collective
        return linear(params[w.name], ins[0])
    if op is ComputeOp.SCALAR_ADD_EPS_MULTIPLY:
        return (1.0 + params[f"eps{node.layer + 1}"]) * ins[0]
    if op is ComputeOp.ADD:
        return ins[0] + ins[1]
    if op is ComputeOp.MUL:
        return ins[0] * ins[1]
    raise NotImplementedError(f"lowering for op {op} not implemented")


# ops whose outputs depend only on their own row — a row subset can be
# selected before them without changing those rows' values
_ROW_LOCAL_OPS = frozenset({
    ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF,
    ComputeOp.FFN_REPEAT, ComputeOp.RELU, ComputeOp.LEAKY_RELU, ComputeOp.ROW_BROADCAST,
    ComputeOp.ADD, ComputeOp.MUL, ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
})


def make_forward(prog: Program):
    """Build (invariant, forward, forward_rows) interpreters over the
    optimized IR.

    forward_rows(params, graphs, carry, rows) evaluates the loop but
    switches to the `rows` node subset at the last point where every
    remaining op is row-local — the training loss then pays for the
    classifier FFN and logits only on train-mask rows (the reference's
    training-subgraph idea extended to the dense tail; on papers100M
    shapes the (N, C) logits buffers dominate HBM)."""
    pre_nodes = [n for n in prog.pre if n.op is not ComputeOp.LOAD]
    loop_nodes = prog.loop.nodes if prog.loop else []
    feats_uid = None
    for n in prog.pre:
        if n.op is ComputeOp.LOAD:
            feats_uid = n.outputs[0].uid

    # the carry exports every pre-node output the loop actually reads
    loop_reads = {d.uid for n in loop_nodes for d in n.inputs}

    # cut = first index from which every node is row-local
    cut = len(loop_nodes)
    while cut > 0 and loop_nodes[cut - 1].op in _ROW_LOCAL_OPS:
        cut -= 1

    def invariant(graphs, x):
        env = {feats_uid: x}
        for node in pre_nodes:
            env[node.outputs[0].uid] = _eval_node(node, env, {}, graphs)
        return {u: v for u, v in env.items() if u in loop_reads or u == feats_uid}

    def forward(params, graphs, carry):
        env = dict(carry) if isinstance(carry, dict) else {feats_uid: carry}
        out = None
        for node in loop_nodes:
            out = _eval_node(node, env, params, graphs)
            env[node.outputs[0].uid] = out
        return out

    def forward_rows(params, graphs, carry, rows):
        env = dict(carry) if isinstance(carry, dict) else {feats_uid: carry}
        n_full = graphs[0].n_pad
        out = None
        for i, node in enumerate(loop_nodes):
            if i == cut:
                env = {
                    u: v[rows]
                    if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == n_full
                    else v
                    for u, v in env.items()
                }
            out = _eval_node(node, env, params, graphs)
            env[node.outputs[0].uid] = out
        if cut == len(loop_nodes):
            out = out[rows]
        return out

    # always return the invariant fn so the loop carry is a dict — the
    # per-epoch extras channel (_ra/_rb for dynamic sampling) rides in it
    return invariant, forward, forward_rows
