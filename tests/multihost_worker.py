"""Worker process for the 2-process jax.distributed test.

Spawned by tests/test_multihost.py as `python multihost_worker.py
<rank> <port> <out.json>`.  Each of the 2 processes exposes 2 virtual
CPU devices, joins the cluster through parallel.multihost.initialize
(the multi-host entry point the reference lacks — its MULTI_NODE Environment
enum values are dead, reference: src/codegen/common.h:22-29), builds
the GLOBAL 4-device mesh, and runs the standard sharded GCN training
step.  The loss is emitted per rank so the parent can assert the two
processes computed the same replicated value — i.e. the collectives
really crossed the process boundary.
"""
import json
import os
import sys


def main():
    rank, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    # two virtual CPU devices per process, set before the first jax op
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    from gala_tpu.parallel.multihost import initialize, is_primary

    n_proc = initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=rank,
    )
    assert n_proc == 2, f"process_count={n_proc} (cluster join failed)"
    assert len(jax.devices()) == 4, jax.devices()
    assert len(jax.local_devices()) == 2
    assert is_primary() == (rank == 0)

    import jax.tree_util as jtu
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gala_tpu.data.synthetic import synthetic_dataset
    from gala_tpu.parallel.graph import ShardedGraph
    from gala_tpu.parallel.mesh import make_mesh
    from gala_tpu.parallel.train import make_sharded_train_step

    # deterministic host-side build: both processes hold the identical
    # global arrays; device_put slices out each process's addressable
    # shards (the multi-host H2D path)
    g_host, feats, labels, masks = synthetic_dataset(
        n=300, avg_degree=8, n_feats=24, n_classes=5, seed=7
    )
    mesh = make_mesh(4)  # global mesh: 2 processes x 2 local devices
    sg = ShardedGraph.from_host(g_host, n_shards=4)
    ns = NamedSharding(mesh, P("data"))
    put = lambda a: jax.device_put(a, ns)  # noqa: E731
    x = put(sg.pad_nodes(feats))
    y = put(sg.pad_nodes(labels))
    tm = put(sg.pad_nodes(masks["train"]))
    sg = jtu.tree_map(put, sg)

    params, opt_state, step, _fwd = make_sharded_train_step(
        mesh, sg, 24, 16, 5
    )
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, x, y, tm)
        # loss is replicated (out_specs=P()) — fetchable on every process
        losses.append(float(loss))

    with open(out_path, "w") as f:
        json.dump({"rank": rank, "n_proc": n_proc, "losses": losses}, f)


if __name__ == "__main__":
    main()
