#!/usr/bin/env python
"""Evaluation harness: the reference's figure/table jobs on the GPU.

Mirrors scripts/Evaluations/*.py of the reference (Figures-16-17, 18, 19,
20, Tables 5-7) with the same CSV row schema so downstream analysis
ports: each run appends `dataset,model,<numbers>` rows to stat_<job>.csv.

Jobs:
  fig16   inference+training time, 4 models x datasets
  table5  CIR-vs-DIR optimization breakdown {none,cir,dir,all}
  fig18   scalability: layers {2,3,4,8} x hidden {32..1024}, GCN
  fig19   memory vs time (print_memory mode)
  fig20   input-aware (opt_input) vs hand-tuned schedules
  table6  graph-size scaling (scale fractions of Products)
  table7  sampling modes {data, kernel, dynamic, none} + accuracy

Usage: python scripts/evaluate.py --job fig16 --scale 0.05 --iters 30
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODELS = ["gcn", "gat", "gin", "sage"]
# the reference's full Figure-16 matrix (Figures-16-17.py:7-12); use
# --datasets / --scale to subset when chip time is constrained
DATASETS = ["Cora", "Pubmed", "CoraFull", "Reddit", "Arxiv", "Products"]

GCN_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    deg = G.graphs.degrees();
    norm = dsl.fn.pow(deg, -0.5);
    res = norm * G.node.feats;
    res = aggregate_fn(G.graphs, res);
    res = dsl.nn.ffn(res, out=hs);
    res = norm * res;
    G.node.feats = nonln_fn(res);
}
"""
GAT_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
edgeFn = dsl.get_edge_aggregate(fn = dsl.fn.sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn, edge_fn) {
    res = dsl.nn.ffn(G.node.feats, out=hs);
    attnL = dsl.nn.ffn(res, out=1);
    attnR = dsl.nn.ffn(res, out=1);
    attn = edge_fn(G, attnL, attnR);
    G.edges.vals = dsl.fn.softmax(G, attn);
    res = aggregate_fn(G.graphs, res);
    G.node.feats = nonln_fn(res);
}
"""
GIN_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    res_n = aggregate_fn(G.graphs, G.node.feats);
    res = dsl.nn.scalar(1) * G.node.feats;
    res = res + res_n;
    res = dsl.nn.ffn(res, out=hs);
    G.node.feats = nonln_fn(res);
}
"""
SAGE_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_mean);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    res_n = aggregate_fn(G.graphs, G.node.feats);
    res = dsl.nn.ffn(res_n, out=hs) + dsl.nn.ffn(res, out=hs);
    G.node.feats = nonln_fn(res);
}
"""
BODIES = {"gcn": GCN_BODY, "gat": GAT_BODY, "gin": GIN_BODY, "sage": SAGE_BODY}


def make_dsl(model: str, dataset: str, layers=2, hidden=32, iters=100,
             schedule: str = "", heads: int = 1) -> str:
    body = BODIES[model]
    if model == "gat" and heads > 1:
        # multi-head GAT (BASELINE.json configs[2]: 3-layer 8-head):
        # heads share one fused slot gather, per-head softmax/reduce
        schedule = f"attention_heads({heads});\n" + schedule
    inits = []
    for i in range(layers):
        size = str(hidden) if i < layers - 1 else "G.labels.size()"
        nonln = "non_ln" if i < layers - 1 else "null"
        extra = ", edgeFn" if model == "gat" else ""
        inits.append(f"\tl{i+1} = L1(G, {size}, {nonln}, aggrFn{extra});")
    return (
        f'G = load_dataset("{dataset}");\n{body}\n'
        "M1 = model(G, non_ln) {\n" + "\n".join(inits) + "\n}\n"
        "m1 = M1(G, dsl.non_ln.ReLU);\n"
        f"m1.train(iters={iters}, validation_step=5);\n"
        "res = m1.eval();\n# schedule\n" + schedule
    )


def run_one(src: str, mode="train", iters=30, data=None, scale=1.0, **low_kw):
    import gala_tpu

    cm = gala_tpu.compile_source(src, mode=mode, data=data, scale=scale, **low_kw)
    res = cm.train(iters=iters)
    return cm, res


def data_kind(args, dataset: str) -> str:
    """Provenance marker written into every accuracy-bearing CSV row, so
    a synthetic stand-in accuracy is never silently diffed against the
    reference's real-dataset numbers.  'real'
    only when --data-root points at an exported GALA npy dir for this
    dataset (scripts/export_npy.py layout)."""
    if args.data_root:
        from gala_tpu.data.datasets import canonical_name

        p = os.path.join(args.data_root, canonical_name(dataset), "Adj_src.npy")
        if os.path.exists(p):
            return "real"
    return "synthetic"


def append_csv(path: str, header: str, row: str):
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(header + "\n")
        f.write(row + "\n")
    print(row)


def job_fig16(args):
    out = os.path.join(args.outdir, "stat_fig16.csv")
    for dataset in args.datasets:
        for model in args.models:
            src = make_dsl(model, dataset, iters=args.iters,
                           layers=args.layers[0], heads=args.heads)
            cm, res = run_one(src, iters=args.iters, scale=args.scale,
                              strategy=args.strategy,
                              data_root=args.data_root)
            label = model if args.heads <= 1 or model != "gat" else (
                f"{model}-h{args.heads}"
            )
            if args.tag:
                label = f"{label}-{args.tag}"
            append_csv(
                out, "dataset,model,inference_time,total_time,accuracy,data",
                f"{dataset},{label},{res.inference_time},{res.total_time},"
                f"{res.max_accuracy},{data_kind(args, dataset)}",
            )


def job_fig18(args):
    out = os.path.join(args.outdir, "stat_fig18.csv")
    for layers in args.layers:
        for hidden in args.hidden:
            src = make_dsl("gcn", args.datasets[0], layers=layers, hidden=hidden)
            cm, res = run_one(src, iters=args.iters, scale=args.scale)
            append_csv(
                out, "dataset,layers,hidden,inference_time,total_time",
                f"{args.datasets[0]},{layers},{hidden},{res.inference_time},{res.total_time}",
            )


def job_fig19(args):
    """Memory-vs-time schedule tradeoff (reference: Figure-19.py
    exec_types ["memory", "time"]), swept over every dataset in
    --datasets (the reference runs one; more points make the tradeoff
    curve falsifiable)."""
    out = os.path.join(args.outdir, "stat_fig19.csv")
    variants = [
        ("time", ""),
        ("memory", "training_subgraph(false);\ntrain_code_motion(false);\n"),
    ]
    for dataset in args.datasets:
        for label, sched in variants:
            src = make_dsl("gcn", dataset, schedule=sched + "print_memory(true);\n")
            cm, res = run_one(src, iters=args.iters, scale=args.scale)
            append_csv(
                out, "dataset,variant,memory_mb,inference_time,total_time",
                f"{dataset},{label},{res.memory_mb},{res.inference_time},{res.total_time}",
            )


def job_fig20(args):
    out = os.path.join(args.outdir, "stat_fig20.csv")
    for dataset in args.datasets:
        hand = make_dsl("gcn", dataset)
        auto = make_dsl("gcn", dataset, schedule=f'G=G.opt_input("{dataset}");\n')
        for label, src in [("hand", hand), ("auto", auto)]:
            cm, res = run_one(src, iters=args.iters, scale=args.scale)
            append_csv(
                out, "dataset,schedule,inference_time,total_time",
                f"{dataset},{label},{res.inference_time},{res.total_time}",
            )


def job_table5(args):
    """CIR-vs-DIR optimization breakdown (reference: Table-5.py +
    tests/GALA-DSL/ablations/speedups/cir-vs-dir/).  Variant mapping to
    this stack: 'none' = XLA segment baseline with all passes off (the
    reference's coarsen=1 default-kernel build); 'cir' = compute
    transform on (coarsened kernels -> binned-ELL); 'dir' = data
    transform on (ordered column tiling -> chunked segment_scan);
    'all' = both + operator_reordering/sparse_rewrites enabled.

    The 'dir' row runs with GALA_FORCE_COL_TILE=1: the compiler's
    memory gate (lowering/lower.py) otherwise drops below-budget
    hand chunking as a measured loss, which would make the ablation
    axis unmeasurable.  'all' runs WITHOUT the force — it reports what
    a user's all-optimizations schedule actually executes (gate
    active), so all ~= cir by design."""
    out = os.path.join(args.outdir, "stat_table5.csv")
    OFF4 = ("operator_reordering(false);\nsparse_rewrites(false);\n"
            "training_subgraph(false);\ntrain_code_motion(false);\n")
    OFF2 = "training_subgraph(false);\ntrain_code_motion(false);\n"
    variants = [
        ("none", OFF4, "segment", False),
        ("cir", "aggrFn=aggrFn.coarsen(2);\n" + OFF4, "bell", False),
        ("dir", "G=G.col_tile(37000);\n" + OFF4, "segment_scan", True),
        ("all", "aggrFn=aggrFn.coarsen(2);\nG=G.col_tile(37000);\n" + OFF2,
         "bell", False),
    ]
    for dataset in args.datasets:
        for label, sched, strat, force in variants:
            src = make_dsl("gcn", dataset, schedule=sched)
            if force:
                os.environ["GALA_FORCE_COL_TILE"] = "1"
            try:
                cm, res = run_one(src, mode="inference", iters=args.iters,
                                  scale=args.scale, strategy=strat)
            finally:
                os.environ.pop("GALA_FORCE_COL_TILE", None)
            append_csv(
                out, "dataset,opts,inference_time,total_time",
                f"{dataset},{label},{res.inference_time},{res.total_time}",
            )


def job_table6(args):
    """Graph-size scaling via node-sampled fractions (reference:
    Table-6.py runs papers100M_P{1,2,5,10,20})."""
    out = os.path.join(args.outdir, "stat_table6.csv")
    ds = args.t6_dataset
    for frac in args.fractions:
        src = make_dsl("gcn", ds, schedule="print_memory(true);\n")
        cm, res = run_one(src, iters=args.iters, scale=frac * args.scale,
                          dtype=args.jnp_dtype)
        append_csv(
            out, "dataset,fraction,inference_time,total_time,memory_mb",
            f"{ds},{frac},{res.inference_time},{res.total_time},{res.memory_mb}",
        )


def job_table7(args):
    out = os.path.join(args.outdir, "stat_table7.csv")
    modes = {
        "none": "",
        "data": "G=G.sample(20);\n",
        "kernel": "aggrFn=aggrFn.sample(20);\n",
        "dynamic": "aggrFn=aggrFn.sample(20).dynamic();\n",
    }
    for label, sched in modes.items():
        src = make_dsl("gcn", args.datasets[0], schedule=sched + "print_accuracy(true);\n")
        cm, res = run_one(src, iters=args.iters, scale=args.scale,
                          data_root=args.data_root)
        append_csv(
            out, "dataset,sampling,inference_time,accuracy,data",
            f"{args.datasets[0]},{label},{res.inference_time},"
            f"{res.max_accuracy},{data_kind(args, args.datasets[0])}",
        )


JOBS = {
    "fig16": job_fig16,
    "table5": job_table5,
    "fig18": job_fig18,
    "fig19": job_fig19,
    "fig20": job_fig20,
    "table6": job_table6,
    "table7": job_table7,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", choices=sorted(JOBS), required=True)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset scale fraction (synthetic stand-ins)")
    ap.add_argument("--datasets", nargs="+", default=DATASETS)
    ap.add_argument("--models", nargs="+", default=MODELS)
    ap.add_argument("--fractions", nargs="+", type=float,
                    default=[0.01, 0.02, 0.05, 0.1, 0.2])
    ap.add_argument("--layers", nargs="+", type=int, default=[2, 3, 4, 8])
    ap.add_argument("--heads", type=int, default=1,
                    help="GAT attention heads (fig16; hidden % heads == 0)")
    ap.add_argument("--hidden", nargs="+", type=int,
                    default=[32, 64, 128, 256, 512, 1024])
    ap.add_argument("--t6-dataset", default="Products",
                    help="table6 dataset (reference uses papers100M; "
                         "pass Papers100M for fraction-sampled runs)")
    ap.add_argument("--dtype", default=None, choices=[None, "bf16", "f32"],
                    help="activation dtype (bf16 halves device memory for the "
                         "biggest fractions)")
    ap.add_argument("--strategy", default="auto",
                    help="fig16 execution strategy: auto, dense, bell, "
                         "ell, segment or segment_scan")
    ap.add_argument("--tag", default="",
                    help="suffix appended to the fig16 model label so "
                         "strategy-variant rows stay distinguishable")
    ap.add_argument("--data-root", default=None, dest="data_root",
                    help="directory of real exported datasets "
                         "(scripts/export_npy.py layout: <root>/<Name>/"
                         "Adj_src.npy ...); rows carry data=real when "
                         "found, data=synthetic otherwise")
    ap.add_argument("--outdir", default="results")
    args = ap.parse_args()
    args.jnp_dtype = None
    if args.dtype == "bf16":
        import jax.numpy as jnp

        args.jnp_dtype = jnp.bfloat16
    elif args.dtype == "f32":
        import jax.numpy as jnp

        args.jnp_dtype = jnp.float32
    os.makedirs(args.outdir, exist_ok=True)
    JOBS[args.job](args)


if __name__ == "__main__":
    main()
