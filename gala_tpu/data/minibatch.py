"""Minibatch neighbor sampling (the GraphSAGE gather pipeline).

Design: a minibatch is a set of FIXED-SHAPE index tensors —
`targets (B,)`, `n1 (B, f1)`, `n2 (B, f1, f2)` — sampled on the host
(vectorized NumPy over the CSR arrays, no Python per-row loops) while
the feature table stays device-resident.  Only the index tensors cross
host->device (a few MB per epoch), the gathers run on device, and the
whole epoch of batches executes as ONE `lax.scan` dispatch
(gala_tpu.train_minibatch) — the same dispatch-fusion protocol the
full-graph trainer uses.

Sampling formula: neighbor slot j of node v reads neighbor
`(ra*j + rb) %% deg(v)` — the reference's in-kernel LCG
(reference: src/codegen/cuda.h:313-320, src/ops/tiling.h:454-512), with
fresh per-epoch (ra, rb) as the `dynamic` mode
(reference: src/codegen/common.h:822-833).  `ra=1, rb=0` enumerates
neighbors in order (exact mean when fanout is a multiple of the
degree — the testable deterministic mode).  Zero-degree nodes sample
themselves (self fallback).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from gala_tpu.data.csr import HostCSR


@dataclasses.dataclass
class EpochBatches:
    """One epoch of stacked fixed-shape minibatches (leading dim =
    number of batches); feed as `lax.scan` xs."""

    targets: np.ndarray   # (nb, B) int32
    n1: np.ndarray        # (nb, B, f1) int32
    n2: np.ndarray        # (nb, B, f1, f2) int32
    mask: np.ndarray      # (nb, B) bool — False on tail padding


class NeighborSampler:
    """2-hop fixed-fanout sampler over a dst-sorted HostCSR.

    neighbors(v) = in-neighbors (sources of edges into v), matching the
    full-graph aggregation direction out = A @ x.
    """

    def __init__(self, g: HostCSR, fanouts: tuple[int, int],
                 batch_size: int = 512):
        if len(fanouts) != 2:
            raise ValueError("NeighborSampler supports 2-layer fanouts")
        self.row_ptr = g.row_ptr.astype(np.int64)
        self.src = g.src.astype(np.int32)
        self.deg = np.diff(self.row_ptr).astype(np.int64)
        self.fanouts = (int(fanouts[0]), int(fanouts[1]))
        self.batch_size = int(batch_size)
        self.n = g.n_rows

    def _sample(self, nodes: np.ndarray, fanout: int, ra: int, rb: int
                ) -> np.ndarray:
        """(len(nodes), fanout) sampled neighbor ids; self fallback for
        zero-degree nodes.  Fully vectorized."""
        deg = self.deg[nodes]                               # (M,)
        safe = np.maximum(deg, 1)
        j = np.arange(fanout, dtype=np.int64)[None, :]
        off = (ra * j + rb) % safe[:, None]
        idx = self.row_ptr[nodes][:, None] + off
        nbr = self.src[np.minimum(idx, self.src.shape[0] - 1)]
        return np.where(deg[:, None] > 0, nbr, nodes[:, None].astype(np.int32))

    def epoch(self, nodes: np.ndarray, epoch: int, seed: int = 0,
              dynamic: bool = True) -> EpochBatches:
        """Shuffle `nodes`, pad the tail batch (mask=False there), and
        sample the 2-hop neighborhoods of every batch.

        dynamic=True draws fresh LCG (ra, rb) per epoch (the reference's
        dynamic mode); False uses the deterministic (1, 0) enumeration.
        """
        rng = np.random.default_rng(seed + 1000003 * epoch)
        nodes = rng.permutation(np.asarray(nodes, np.int64))
        b = self.batch_size
        pad = (-len(nodes)) % b
        mask = np.ones(len(nodes) + pad, bool)
        if pad:
            mask[len(nodes):] = False
            nodes = np.concatenate([nodes, np.full(pad, nodes[-1])])
        nb = len(nodes) // b
        if dynamic:
            # odd multiplier keeps the LCG full-period for even degrees
            ra = int(rng.integers(1, 1 << 15)) * 2 + 1
            rb = int(rng.integers(0, 1 << 15))
        else:
            ra, rb = 1, 0
        f1, f2 = self.fanouts
        n1 = self._sample(nodes, f1, ra, rb)                # (nb*B, f1)
        n2 = self._sample(n1.reshape(-1).astype(np.int64), f2, ra, rb + 1)
        return EpochBatches(
            targets=nodes.reshape(nb, b).astype(np.int32),
            n1=n1.reshape(nb, b, f1).astype(np.int32),
            n2=n2.reshape(nb, b, f1, f2).astype(np.int32),
            mask=mask.reshape(nb, b),
        )
