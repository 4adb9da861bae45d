#!/usr/bin/env python
"""Multi-chip scaling-efficiency bench (BASELINE: >=80% at 1 -> 2 hosts).

Runs the sharded training step over growing mesh sizes and reports
epoch time + scaling efficiency, weak- or strong-scaling:

  weak   — nodes-per-shard held constant (graph grows with the mesh):
           efficiency = t(1) / t(d)
  strong — one fixed graph partitioned d ways:
           efficiency = t(1) / (d * t(d))

On GPUs run under the normal env; without them, validate the harness
on a virtual CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/bench_scaling.py --devices 1 2 4 8

CPU-mesh times measure the harness, not the interconnect — only
accelerator rows are publishable.  The halo step is the comm-optimal variant (local/remote
edge blocks overlap the all_to_all with local aggregation,
gala_tpu/parallel/ops.py); --no-halo measures the all_gather variant
for the collective-choice comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--nodes", type=int, default=65536,
                    help="graph nodes (per shard for weak, total for strong)")
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--no-halo", action="store_true",
                    help="all_gather variant instead of halo overlap")
    ap.add_argument("--outdir", default=None,
                    help="also append rows to <outdir>/stat_scaling.csv "
                         "(the RESULTS.md source, scripts/report.py)")
    args = ap.parse_args()

    import jax

    n_avail = len(jax.devices())
    sizes = [d for d in args.devices if d <= n_avail]
    if sizes != args.devices:
        print(f"# only {n_avail} devices visible; running {sizes}",
              file=sys.stderr)
    if not sizes:
        sys.exit(f"no requested mesh size fits {n_avail} visible devices")

    import jax.numpy as jnp
    import jax.tree_util as jtu
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gala_tpu.data.synthetic import synthetic_dataset
    from gala_tpu.parallel.graph import ShardedGraph
    from gala_tpu.parallel.mesh import make_mesh
    from gala_tpu.parallel.train import make_sharded_train_step
    from gala_tpu.utils.timing import EpochTimer

    rows = []
    for d in sizes:
        n = args.nodes * d if args.mode == "weak" else args.nodes
        g_host, feats, labels, masks = synthetic_dataset(
            n=n, avg_degree=args.avg_degree, n_feats=args.feats,
            n_classes=16, seed=0,
        )
        mesh = make_mesh(d, model_axis=1)
        sg = ShardedGraph.from_host(g_host, n_shards=d)
        ns = NamedSharding(mesh, P("data"))
        x = jax.device_put(sg.pad_nodes(feats), ns)
        y = jax.device_put(sg.pad_nodes(labels), ns)
        tm = jax.device_put(sg.pad_nodes(masks["train"]), ns)
        sg_dev = jtu.tree_map(lambda a: jax.device_put(a, ns), sg)
        params, opt_state, step, _ = make_sharded_train_step(
            mesh, sg_dev, d_in=args.feats, d_hidden=args.hidden, d_out=16,
            halo=not args.no_halo,
        )
        loss = None
        timer = EpochTimer()
        for e in range(args.iters):
            if e == args.warmup:
                timer.start((params, loss))
            params, opt_state, loss = step(params, opt_state, x, y, tm)
        t = timer.stop((params, opt_state, loss),
                       n=max(args.iters - args.warmup, 1))
        rows.append((d, n, g_host.n_edges, t))

    # efficiency is relative to the smallest mesh actually run (d0):
    # weak keeps per-device work constant, so eff = t(d0)/t(d); strong
    # divides one fixed problem, so eff = d0*t(d0) / (d*t(d))
    d0, _, _, t0 = rows[0]
    backend = jax.devices()[0].platform
    csv_rows = []
    for d, n, e, t in rows:
        eff = (t0 / t) if args.mode == "weak" else (d0 * t0) / (d * t)
        print(json.dumps({
            "devices": d, "nodes": n, "edges": int(e), "mode": args.mode,
            "halo": not args.no_halo, "epoch_s": round(t, 6),
            "edges_per_s": round(e / t, 1),
            "scaling_efficiency": round(eff, 4),
            "backend": backend,
            "publishable": backend not in ("cpu",),
        }))
        csv_rows.append(
            f"{d},{args.mode},{not args.no_halo},{n},{int(e)},"
            f"{round(t, 6)},{round(eff, 4)},{backend}"
        )
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        path = os.path.join(args.outdir, "stat_scaling.csv")
        fresh = not os.path.exists(path)
        with open(path, "a") as f:
            if fresh:
                f.write("devices,mode,halo,nodes,edges,"
                        "epoch_s,scaling_efficiency,backend\n")
            f.write("\n".join(csv_rows) + "\n")


if __name__ == "__main__":
    main()
