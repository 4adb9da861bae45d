"""Text-DSL parser tests against the reference corpus layout.

The op-sequence expectations mirror what the reference's bison actions
produce for each model family (reference: src/frontend/frontend.y:84-280).
"""
import glob
import os
import textwrap

import pytest

from gala_tpu.dsl.parser import parse_file, parse_source
from gala_tpu.dsl.spec import LayerOp

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")


def example_spec(model: str):
    """The shipped examples/<model>.txt program, single-head like the
    reference corpus programs (examples/gat.txt schedules 4 heads)."""
    spec = parse_file(os.path.join(EXAMPLES, f"{model}.txt"))
    spec.attention_heads = 1
    return spec

GCN_SRC = textwrap.dedent("""
    G = load_dataset("Reddit");
    aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
    L1 = layer(G, hs, nonln_fn, aggregate_fn) {
        deg = G.graphs.degrees();
        norm = dsl.fn.pow(deg, -0.5);
        res = norm * G.node.feats;
        res = aggregate_fn(G.graphs, res); // aggregate operation
        res = dsl.nn.ffn(res, out=hs);
        res = norm * res;
        G.node.feats = nonln_fn(res);
    }
    M1 = model(G, non_ln) {
        l1 = L1(G, 32, non_ln, aggrFn);
        l2 = L1(l1, G.labels.size(), null, aggrFn);
    }
    m1 = M1(G, dsl.non_ln.ReLU);
    m1.train(iters=100, validation_step=5);
    res = m1.eval();
    # schedule
    G=G.set_undirected(true);
    G=G.set_unweighted(true);
    feature_size(602);
    label_size(41);
    aggrFn=aggrFn.coarsen(2);
    G=G.col_tile(37000);
""")


def test_gcn_classification():
    spec = parse_source(GCN_SRC)
    assert spec.dataset == "Reddit"
    assert spec.iterations == 100 and spec.valid_step == 5
    assert spec.layer_ops == [
        LayerOp.GET_DEGREES,
        LayerOp.GET_NORMALIZATION,
        LayerOp.MULT_NORM_RES,
        LayerOp.MESSAGE_PASSING_AGGREGATE,
        LayerOp.FEED_FORWARD_NN,
        LayerOp.MULT_NORM_RES,
        LayerOp.NON_LINEARITY,
    ]
    assert spec.num_layers == 2
    assert spec.output_sizes == [32, 41]       # labels.size() resolved
    assert spec.nonln_present == [True, False]
    assert spec.normalization_value == -0.5
    assert spec.graph.undirected and spec.graph.unweighted
    assert spec.graph.feat_size == 602 and spec.graph.label_size == 41
    assert spec.compute.coarsen == 2
    assert spec.col_tile == 37000


def test_schedule_flags_and_sampling():
    src = GCN_SRC + textwrap.dedent("""
        operator_reordering(false);
        training_subgraph(false);
        aggrFn=aggrFn.sample(20).dynamic();
        G=G.sample(5);
        print_accuracy(true);
        G=G.is_sparser(true);
    """)
    spec = parse_source(src)
    assert not spec.passes.operator_reordering
    assert not spec.passes.training_subgraph
    assert spec.passes.sparse_rewrites  # untouched default
    assert spec.compute.sample_dynamic == 20
    assert spec.graph.sample == 5
    assert spec.print_accuracy
    assert spec.graph.sparser


def test_opt_input():
    src = GCN_SRC + '\nG=G.opt_input("../../Data/Reddit/");\n'
    assert parse_source(src).opt_input == "../../Data/Reddit/"


def test_sage_expansion():
    src = textwrap.dedent("""
        G = load_dataset("X");
        aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_mean);
        L1 = layer(G, hs, nonln_fn, aggregate_fn) {
            res_n = aggregate_fn(G.graphs, G.node.feats);
            res = dsl.nn.ffn(res_n, out=hs) + dsl.nn.ffn(res, out=hs);
            G.node.feats = nonln_fn(res);
        }
        M1 = model(G, non_ln) {
            l1 = L1(G, 16, non_ln, aggrFn);
            l2 = L1(l1, G.labels.size(), null, aggrFn);
        }
        m1 = M1(G, dsl.non_ln.ReLU);
        m1.train(iters=10, validation_step=5);
        res = m1.eval();
    """)
    spec = parse_source(src)
    assert spec.layer_ops == [
        LayerOp.GET_DEGREES,
        LayerOp.GET_NORMALIZATION,
        LayerOp.MESSAGE_PASSING_AGGREGATE,
        LayerOp.MULT_NORM_RES,
        LayerOp.ADD_TWO_FFN,
        LayerOp.NON_LINEARITY,
    ]
    assert spec.normalization_value == -1.0  # mean aggregation


def test_full_reference_corpus_parses():
    """Every shipped DSL program (examples/) parses."""
    files = glob.glob(EXAMPLES + "/*.txt")
    assert len(files) >= 4
    for f in files:
        with open(f) as fh:
            spec = parse_source(fh.read())
        assert spec.num_layers > 0, f
        assert spec.layer_ops, f


def test_full_reference_corpus_compiles_through_passes():
    """Every shipped DSL program (examples/) must survive generate_ir +
    the full pass pipeline in both driver modes (compile-level parity,
    beyond parse-level)."""
    from gala_tpu.ir.build import generate_ir
    from gala_tpu.ir.compute_ir import ComputeOp
    from gala_tpu.passes.pipeline import run_passes

    files = sorted(glob.glob(EXAMPLES + "/*.txt"))
    assert len(files) >= 4
    agg_ops = {
        ComputeOp.AGGREGATE_MUL_SUM,
        ComputeOp.FUSED_ATTENTION,
        ComputeOp.AGGREGATE_MUL_SUM_DIRECT,
    }
    for f in files:
        for mode in ("inference", "train"):
            spec = parse_source(open(f).read())
            prog = run_passes(generate_ir(spec), spec, mode=mode)
            nodes = prog.all_nodes()
            assert any(n.op in agg_ops for n in nodes), (f, mode)
            assert prog.loop is not None and prog.loop.iters > 0, (f, mode)


def test_malformed_statements_raise():
    """Malformed or unknown top-level statements must raise a
    DSLSyntaxError naming the statement — not silently compile an
    empty spec (the generic model-init ignore used to swallow them)."""
    from gala_tpu.dsl.parser import DSLSyntaxError

    cases = {
        'G = load_dataset(;': "load_dataset",
        "x = nonsense_fn(1);": "unrecognized",
        # M1 call without a defined M1 block
        'G = load_dataset("Cora"); m1 = M1(G);': "unrecognized",
    }
    for src, frag in cases.items():
        with pytest.raises(DSLSyntaxError, match=frag):
            parse_source(src)


def test_model_init_with_defined_block_is_accepted():
    src = textwrap.dedent("""
        G = load_dataset("Cora");
        aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
        L1 = layer(G, hs, nonln_fn, aggregate_fn) {
            res = aggregate_fn(G.graphs, G.node.feats);
            G.node.feats = nonln_fn(res);
        }
        M1 = model(G, non_ln) {
            l1 = L1(G, 32, non_ln, aggrFn);
        }
        m1 = M1(G, dsl.non_ln.ReLU);
        m1.train(iters=5, validation_step=5);
        res = m1.eval();
    """)
    spec = parse_source(src)
    assert spec.num_layers == 1
