"""Device-mesh helpers.

The reference has no multi-device execution at all (its Environment enum
is aspirational — reference: src/codegen/common.h:22-29, every driver
constructs SINGLE_NODE_SINGLE).  Scale-out here is built in from the
start: a `jax.sharding.Mesh` with

    'data'  — node-partition axis (graph rows + features sharded; the
              GNN analog of data parallelism, and of edge/"context"
              parallelism since each shard owns the edges into its rows)
    'model' — feature/hidden-dimension axis (tensor parallelism for the
              FFN weights; optional, size 1 on small meshes)

XLA lowers the collectives to NCCL (NVLink within a host): all_gather of node features for remote sources,
psum_scatter in the backward (inserted by differentiating shard_map),
psum for replicated-parameter gradients.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, model_axis: int = 1) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    model = model_axis if n % model_axis == 0 else 1
    data = n // model
    arr = np.asarray(devs[:n]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def node_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (nodes) split over the 'data' axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
