"""Test configuration: CPU with 8 virtual devices unless a platform is set.

Multi-chip sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), per the repo testing contract.
JAX_PLATFORMS is pinned to the CPU only when the caller left it unset,
so `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` reaches the card.
Must run before jax is imported anywhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_dataset():
    from gala_tpu.data.synthetic import synthetic_dataset

    return synthetic_dataset(n=300, avg_degree=8, n_feats=24, n_classes=5, seed=7)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
