"""Lowering tests: DSL-compiled programs match the hand-written models
numerically and train to accuracy (compiler-vs-oracle equivalence)."""
import numpy as np
import pytest

from gala_tpu.lowering.lower import lower
from tests.test_parser import GCN_SRC, example_spec


def _spec(model="gcn"):
    spec = example_spec(model)
    spec.graph.feat_size = 24
    spec.graph.label_size = 5
    spec.output_sizes = [16, 5]
    spec.col_tile = 0
    return spec


def test_lowered_gcn_matches_hand_model(small_dataset):
    """Same weights -> same logits as gala_tpu.models.gcn (passes off)."""
    import jax
    from gala_tpu.models import gcn
    from gala_tpu.ops.graph import Graph

    spec = _spec("gcn")
    for k in vars(spec.passes):
        setattr(spec.passes, k, False)
    cm = lower(spec, mode="inference", data=small_dataset)

    g_host, feats, *_ = small_dataset
    g = Graph.from_host(g_host, strategy=cm.full_graphs[0].strategy)
    hand_params = gcn.init(jax.random.key(0), 24, [16], 5)
    lowered_params = {
        "weight1": hand_params["fc"][0],
        "weight2": hand_params["fc"][1],
    }
    hand_out = np.asarray(gcn.forward(hand_params, [g, g], g.pad_nodes(feats)))
    low_out = np.asarray(cm.forward(lowered_params, cm.full_graphs, cm.x))
    np.testing.assert_allclose(low_out, hand_out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", [
    "gcn",
    pytest.param("gat", marks=pytest.mark.slow),
    pytest.param("gin", marks=pytest.mark.slow),
    "sage",
])
@pytest.mark.parametrize("mode", ["inference", "train"])
def test_compiled_model_trains(model, mode, small_dataset):
    cm = lower(_spec(model), mode=mode, data=small_dataset)
    res = cm.train(iters=30, warmup=2)
    assert res.losses[-1] < res.losses[0]
    assert res.max_accuracy > 0.7, f"{model}/{mode}: {res.max_accuracy}"
    if mode == "train":
        assert cm.train_graphs is not None  # subgraph pass active


def test_compile_source_api(small_dataset):
    import gala_tpu

    cm = gala_tpu.compile_source(GCN_SRC, data=small_dataset)
    line = cm.run(iters=8)
    parts = line.split(",")
    assert len(parts) == 2 and float(parts[1]) >= float(parts[0])


def test_subgraph_training_matches_full_on_train_loss(small_dataset):
    """Training subgraphs must not change the train-mask loss trajectory
    start (they contain every edge reaching the mask)."""
    import jax
    from gala_tpu.train import masked_cross_entropy

    specs = []
    for sub in (False, True):
        spec = _spec("gcn")
        spec.passes.training_subgraph = sub
        cm = lower(spec, mode="train", data=small_dataset)
        params = cm.make_params(seed=0)
        gs = cm.train_graphs if (sub and cm.train_graphs) else cm.full_graphs
        carry = cm.invariant(gs, cm.x) if cm.invariant else cm.x
        logits = cm.forward(params, gs, carry)
        specs.append(
            float(masked_cross_entropy(logits, cm.labels, cm.train_mask))
        )
    assert abs(specs[0] - specs[1]) < 1e-4


@pytest.mark.slow
def test_multihead_gat_dsl(small_dataset):
    """attention_heads(H) schedule directive: hidden GAT layers attend
    per-head feature slices through the one fused slot gather; the final
    layer stays single-head."""
    from gala_tpu.ir.compute_ir import ComputeOp

    spec = _spec("gat")
    spec.output_sizes = [32, 5]
    spec.attention_heads = 4
    cm = lower(spec, mode="train", data=small_dataset)
    fused = [n for n in cm.program.all_nodes()
             if n.op is ComputeOp.FUSED_ATTENTION]
    assert len(fused) == 2
    widths = sorted(n.inputs[1].cols for n in fused)
    assert widths == [1, 4]          # layer-2 single head, layer-1 four
    res = cm.train(iters=40, warmup=2)
    assert res.max_accuracy > 0.7, res.max_accuracy


def test_multihead_gat_dsl_guards(small_dataset):
    spec = _spec("gat")
    spec.output_sizes = [30, 5]      # 30 % 4 != 0
    spec.attention_heads = 4
    with pytest.raises(ValueError, match="divide"):
        lower(spec, mode="train", data=small_dataset)
