"""Graph reordering: permutation generation + application (host / NumPy).

Clean-room equivalent of the reference's reordering machinery
(reference: src/ops/reordering.h:155-1105 — rowReorder, rowPermuteDense*,
colReorder, getAcendingOrder/getDecendingOrder).  Note the reference's
rabbit-order itself is not in-tree (its call sites are commented out,
reference: tests/common.h:634-699; only the apply-permutation machinery
is live) — here the live machinery is matched and two practical
locality orders are provided (degree sort and BFS/RCM).

Reordering changes gather locality (how much cache reuse each sweep
gets); it also remains part of
the schedule surface (`dsl.reorder.rabbit` token,
reference: src/frontend/frontend.l:42) and improves ELL bin packing.
"""
from __future__ import annotations

import numpy as np

from gala_tpu.data.csr import HostCSR, coo_to_csr


def degree_order(g: HostCSR, descending: bool = True) -> np.ndarray:
    """Permutation sorting nodes by degree
    (reference: reordering.h:1085 getAcendingOrder / :1095 getDecending)."""
    deg = g.degrees
    order = np.argsort(-deg if descending else deg, kind="stable")
    return order.astype(np.int64)


def bfs_order(g: HostCSR, reverse: bool = True) -> np.ndarray:
    """Cuthill-McKee-style BFS order from the lowest-degree node
    (reverse=True gives RCM).  O(N + E)."""
    n = g.n_rows
    deg = g.degrees
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # iterate components, seeded by ascending degree
    seeds = np.argsort(deg, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            next_queue: list[int] = []
            for u in queue:
                order[pos] = u
                pos += 1
                lo, hi = g.row_ptr[u], g.row_ptr[u + 1]
                nbrs = g.src[lo:hi]
                fresh = nbrs[~visited[nbrs]]
                if fresh.size:
                    # unique preserves ascending-degree tie order well enough
                    fresh = np.unique(fresh)
                    visited[fresh] = True
                    next_queue.extend(fresh[np.argsort(deg[fresh], kind="stable")])
            queue = next_queue
    if reverse:
        order = order[::-1].copy()
    return order


def apply_reorder(
    g: HostCSR,
    perm: np.ndarray,
    feats: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    masks: dict | None = None,
):
    """Relabel nodes so new id i = old id perm[i]; rebuild the CSR and
    permute all node-aligned arrays (the multi-array rowReorder variant,
    reference: src/ops/reordering.h:369).

    Returns (graph, feats, labels, masks, inv_perm) — inv_perm maps old
    ids to new ids, for translating external node references.
    """
    n = g.n_rows
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    new_src = inv[g.src.astype(np.int64)]
    new_dst = inv[g.dst.astype(np.int64)]
    g2 = coo_to_csr(new_src, new_dst, g.vals, n_rows=n, n_cols=g.n_cols)
    feats2 = feats[perm] if feats is not None else None
    labels2 = labels[perm] if labels is not None else None
    masks2 = {k: v[perm] for k, v in masks.items()} if masks else None
    return g2, feats2, labels2, masks2, inv


def reorder_dataset(data, method: str = "degree"):
    """Convenience: reorder a (HostCSR, feats, labels, masks) tuple."""
    g, feats, labels, masks = data
    if method == "degree":
        perm = degree_order(g)
    elif method in ("rcm", "bfs"):
        perm = bfs_order(g, reverse=method == "rcm")
    elif method == "random":
        perm = np.random.default_rng(0).permutation(g.n_rows)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    g2, f2, l2, m2, _ = apply_reorder(g, perm, feats, labels, masks)
    return g2, f2, l2, m2
