"""Golden-IR tests for the four middle-end passes (SURVEY.md §4: the
reference verifies these only via end-to-end ablation DSLs; here each pass
has direct IR-shape assertions plus numeric equivalence via lowering)."""
import numpy as np
import pytest

from gala_tpu.dsl.parser import parse_file, parse_source
from gala_tpu.dsl.spec import ModelSpec
from gala_tpu.ir.build import generate_ir
from gala_tpu.ir.compute_ir import ComputeOp
from gala_tpu.passes.code_motion import training_invariant_code_motion
from gala_tpu.passes.reorder import operator_reordering
from gala_tpu.passes.sparsify import sparsity_aware_rewrites
from gala_tpu.passes.subgraph import training_subgraph
from tests.test_parser import GCN_SRC


def _gcn_spec(sparser=False) -> ModelSpec:
    spec = parse_source(GCN_SRC)
    spec.graph.feat_size = 24
    spec.graph.label_size = 5
    spec.output_sizes = [16, 5]
    spec.col_tile = 0
    spec.graph.sparser = sparser
    return spec


def _ops(nodes):
    return [n.op for n in nodes]


def test_reorder_moves_shrinking_ffn_before_aggregate():
    prog = generate_ir(_gcn_spec())
    prog = operator_reordering(prog)
    ops = _ops(prog.loop.nodes)
    # layer-1: the aggregation chain is PARAM-FREE (hoistable by TIM /
    # XLA loop-invariant motion), so the shrinking FFN does NOT bubble
    # past it (hoisting cost model — see passes/reorder.py docstring)
    i_ffn1 = ops.index(ComputeOp.FFN)
    i_agg1 = ops.index(ComputeOp.AGGREGATE_MUL_SUM)
    assert i_agg1 < i_ffn1
    # layer-2: its chain consumes layer-1's FFN output (param-dependent,
    # nothing hoists), so the shrinking 16->5 FFN still moves early
    i_ffn2 = ops.index(ComputeOp.FFN, i_ffn1 + 1)
    i_agg2 = ops.index(ComputeOp.AGGREGATE_MUL_SUM, i_agg1 + 1)
    assert i_ffn2 < i_agg2
    # wiring stays acyclic: no node consumes its own output
    for n in prog.loop.nodes:
        assert all(d is not n.outputs[0] for d in n.inputs)


def test_reorder_tim_mode_keeps_ffn_late():
    prog = generate_ir(_gcn_spec())
    prog = operator_reordering(prog, enable_tim=True)
    ops = _ops(prog.loop.nodes)
    assert ops.index(ComputeOp.AGGREGATE_MUL_SUM) < ops.index(ComputeOp.FFN)


def test_sparsity_rewrite_folds_norm_sandwich():
    prog = generate_ir(_gcn_spec(sparser=True))
    prog = sparsity_aware_rewrites(prog)
    ops = _ops(prog.loop.nodes)
    assert ComputeOp.AGGREGATE_EDGE_MUL in ops
    assert ComputeOp.ROW_BROADCAST not in ops  # both sandwiches folded
    # aggregations now carry edge values
    aggs = [n for n in prog.loop.nodes if n.op is ComputeOp.AGGREGATE_MUL_SUM]
    assert all(len(a.inputs) == 3 for a in aggs)


def test_code_motion_hoists_invariant_ops():
    prog = generate_ir(_gcn_spec(sparser=True))
    prog = operator_reordering(prog, enable_tim=True)
    prog = sparsity_aware_rewrites(prog)
    prog = training_invariant_code_motion(prog)
    pre_ops = _ops(prog.pre)
    loop_ops = _ops(prog.loop.nodes)
    # first-layer aggregation hoisted; no learned op hoisted
    assert ComputeOp.AGGREGATE_MUL_SUM in pre_ops
    assert ComputeOp.FFN not in pre_ops
    # beyond-prefix hoisting: every edge-value precompute left the loop
    assert ComputeOp.AGGREGATE_EDGE_MUL not in loop_ops


def test_training_subgraph_creates_transforms():
    prog = generate_ir(_gcn_spec())
    prog = training_subgraph(prog)
    assert prog.uses_training_subgraphs
    from gala_tpu.ir.data_ir import DataOpt

    subs = [t for t in prog.transforms if t.transforms[0].kind is DataOpt.SUBGRAPH]
    assert len(subs) == 2  # one per layer


def test_passes_preserve_numerics(small_dataset):
    """With zero biases the optimized program computes the *same function*
    as the naive one.  (With biases, moving an FFN across an aggregation
    changes A@(XW+b) into (A@X)W+b — an approximation the reference's
    reordering makes too, since its generated torch Linears carry biases;
    the model family and accuracy are preserved, the function is not.)"""
    import jax

    from gala_tpu.lowering.lower import lower

    outs = {}
    for label, flags in [
        ("none", dict(operator_reordering=False, sparse_rewrites=False,
                      training_subgraph=False, train_code_motion=False)),
        ("all", dict()),
    ]:
        spec = _gcn_spec(sparser=True)
        for k, v in flags.items():
            setattr(spec.passes, k, v)
        cm = lower(spec, mode="train", data=small_dataset)
        params = cm.make_params(seed=0)
        params = jax.tree.map(lambda p: p, params)
        for name in params:
            params[name]["b"] = params[name]["b"] * 0.0
        graphs = cm.full_graphs
        carry = cm.invariant(graphs, cm.x) if cm.invariant else cm.x
        outs[label] = np.asarray(cm.forward(params, graphs, carry))
    np.testing.assert_allclose(outs["none"], outs["all"], rtol=1e-3, atol=1e-4)


def test_passes_preserve_accuracy(small_dataset):
    """With biases the optimized program is a different (equally good)
    parameterization: trained accuracy must match the naive build."""
    from gala_tpu.lowering.lower import lower

    accs = {}
    for label, flags in [
        ("none", dict(operator_reordering=False, sparse_rewrites=False,
                      training_subgraph=False, train_code_motion=False)),
        ("all", dict()),
    ]:
        spec = _gcn_spec(sparser=True)
        for k, v in flags.items():
            setattr(spec.passes, k, v)
        cm = lower(spec, mode="train", data=small_dataset)
        accs[label] = cm.train(iters=40, warmup=2).max_accuracy
    assert accs["all"] >= accs["none"] - 0.05


def _ffn_recompute_prog():
    """Hand-built loop triggering the FFN-recompute pattern: an
    expanding FFN (8 -> 32) whose output feeds BOTH a relu (first use)
    and a dense-graph aggregation (second use)."""
    from gala_tpu.ir.compute_ir import (
        ComputeNode, OpType, Program, TrainingLoop,
    )
    from gala_tpu.ir.data_ir import DataFormat, DataNode

    x = DataNode(name="feats", fmt=DataFormat.RM, rows=-1, cols=8)
    G = DataNode(name="graph", fmt=DataFormat.CSR, rows=-1, cols=-1, index=0)
    w = DataNode(name="weight1", fmt=DataFormat.CM, rows=8, cols=32)
    h = DataNode(name="h", fmt=DataFormat.RM, rows=-1, cols=32, derived=True)
    r = DataNode(name="r", fmt=DataFormat.RM, rows=-1, cols=32, derived=True)
    a = DataNode(name="res", fmt=DataFormat.RM, rows=-1, cols=32, derived=True)
    o = DataNode(name="out", fmt=DataFormat.RM, rows=-1, cols=32, derived=True)
    prog = Program(
        pre=[ComputeNode(OpType.UPDATE_NODE, ComputeOp.LOAD, [], [x])],
        loop=TrainingLoop(iters=5, nodes=[
            ComputeNode(OpType.UPDATE_NODE, ComputeOp.FFN, [x, w], [h], layer=0),
            ComputeNode(OpType.UPDATE_NODE, ComputeOp.RELU, [h], [r], layer=0),
            ComputeNode(OpType.AGGREGATE_NODE, ComputeOp.AGGREGATE_MUL_SUM,
                        [h, G], [a], layer=0),
            ComputeNode(OpType.POINTWISE, ComputeOp.ADD, [a, r], [o], layer=0),
        ]),
        n_layers=1,
    )
    return prog


def test_ffn_recompute_rewrite_shape():
    from gala_tpu.passes.sparsify import ffn_recompute_rewrites

    prog = ffn_recompute_rewrites(_ffn_recompute_prog())
    ops = _ops(prog.loop.nodes)
    assert ComputeOp.FFN_REPEAT in ops
    # aggregation now consumes the NARROW pre-FFN features
    agg = next(n for n in prog.loop.nodes if n.op is ComputeOp.AGGREGATE_MUL_SUM)
    assert agg.inputs[0].cols == 8 and agg.outputs[0].cols == 8
    rep = next(n for n in prog.loop.nodes if n.op is ComputeOp.FFN_REPEAT)
    # FFN_REPEAT shares the original weight and feeds the old consumers
    assert rep.inputs[1].name == "weight1"
    assert rep.inputs[0] is agg.outputs[0]
    add = next(n for n in prog.loop.nodes if n.op is ComputeOp.ADD)
    assert add.inputs[0] is rep.outputs[0]
    # the original FFN survives for its other consumer (the relu)
    assert ComputeOp.FFN in ops
    # the rewrite fires once, not repeatedly
    assert ops.count(ComputeOp.FFN_REPEAT) == 1


def test_ffn_recompute_skips_shrinking_and_sparser():
    from gala_tpu.passes.sparsify import ffn_recompute_rewrites

    # shrinking FFN: no rewrite
    prog = _ffn_recompute_prog()
    prog.loop.nodes[0].inputs[0].cols = 64
    prog = ffn_recompute_rewrites(prog)
    assert ComputeOp.FFN_REPEAT not in _ops(prog.loop.nodes)
    # sparser graph: the SDDVV rewrite owns that case
    prog = _ffn_recompute_prog()
    for n in prog.loop.nodes:
        if n.op is ComputeOp.AGGREGATE_MUL_SUM:
            n.inputs[1].sparser = True
    prog = ffn_recompute_rewrites(prog)
    assert ComputeOp.FFN_REPEAT not in _ops(prog.loop.nodes)


def test_ffn_recompute_numeric_equivalence(small_dataset):
    """A @ (X W) == (A @ X) W with biases zeroed (the reference applies
    the same fc module after aggregation, accepting the bias shift —
    src/codegen/common.h:1243-1247; the linear part must match exactly)."""
    import jax
    from gala_tpu.lowering.interp import make_forward, make_init_params
    from gala_tpu.ops.graph import Graph
    from gala_tpu.passes.sparsify import ffn_recompute_rewrites

    g_host, feats, *_ = small_dataset
    g = Graph.from_host(g_host, strategy="segment")
    xp = g.pad_nodes(np.random.default_rng(0).normal(
        size=(g.n_nodes, 8)).astype(np.float32))

    outs = []
    for rewrite in (False, True):
        prog = _ffn_recompute_prog()
        if rewrite:
            prog = ffn_recompute_rewrites(prog)
            assert ComputeOp.FFN_REPEAT in _ops(prog.loop.nodes)
        invariant, forward, _ = make_forward(prog)
        params = make_init_params(prog)(jax.random.key(0), {})
        params["weight1"]["b"] = params["weight1"]["b"] * 0.0
        carry = invariant([g], xp)
        outs.append(np.asarray(forward(params, [g], carry)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-4)
