"""Dataset registry and resolution.

The reference evaluates on six graphs exported to its npy layout
(reference: scripts/Data/get_all_datasets.py:4-10) — shapes below.  This
image has no network egress, so resolution order is:

1. an explicit data tuple passed by the caller,
2. a GALA-layout npy directory (data_root/<name>/Adj_src.npy ...),
3. a synthetic R-MAT stand-in with the registered shape (scaled by
   `scale` so CPU tests stay fast), with planted-community labels.
"""
from __future__ import annotations

import os

import numpy as np

from gala_tpu.data.csr import coo_to_csr, normalize_self_loops, symmetrize
from gala_tpu.data.io import load_gala_npy
from gala_tpu.data.synthetic import rmat_edges, synthetic_dataset

# name -> (n_nodes, n_edges, n_feats, n_classes)
REGISTRY: dict[str, tuple[int, int, int, int]] = {
    "Cora": (2_708, 10_556, 1_433, 7),
    "Pubmed": (19_717, 88_648, 500, 3),
    "CoraFull": (19_793, 126_842, 8_710, 70),
    "Arxiv": (169_343, 1_166_243, 128, 40),
    "Reddit": (232_965, 114_615_892, 602, 41),
    "Products": (2_449_029, 123_718_280, 100, 47),
    # evaluated only node-sampled to 1-20% (reference: Table-6.py;
    # scripts/Data exports papers100M_P<frac> subsets)
    "Papers100M": (111_059_956, 1_615_685_872, 128, 172),
    # geometric generator family (reference: src/utils/generator.h
    # generate_rgg2D) with spatial-tile node ids — the locality-bearing
    # graph (a gather chunk re-reads its source rows ~4x vs ~0.17x on
    # the R-MAT community stand-ins);
    # e is the expected n*avg_degree at avg_degree 16
    "RGG2D": (1_500_000, 24_000_000, 128, 32),
}
_ALIASES = {
    "ogbn-arxiv": "Arxiv",
    "ogbn-products": "Products",
    "ogbn-papers100M": "Papers100M",
    "papers100M": "Papers100M",
    "arxiv": "Arxiv",
    "products": "Products",
    "cora": "Cora",
    "pubmed": "Pubmed",
    "reddit": "Reddit",
}


def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


# bump when a generator changes (invalidates the cache for the graphs
# it produces; per-name so an RGG tweak doesn't force the expensive
# R-MAT stand-ins to regenerate mid-queue).  RGG2D v2: spatial ids
# follow a Morton curve instead of row-major grid order; v3: feats/
# split draw from an independent rng stream (the shared stream
# correlated features with positions, i.e. with labels)
_GEN_VERSION = 1
_GEN_VERSION_BY_NAME = {"RGG2D": 3}


def _cache_dir() -> str | None:
    d = os.environ.get("GALA_DATASET_CACHE")
    if d == "":
        return None  # explicitly disabled
    return d or os.path.join(
        os.path.expanduser("~"), ".cache", "gala_tpu", "datasets"
    )


def _cache_load(path: str):
    from gala_tpu.data.csr import HostCSR

    z = np.load(path)
    g = HostCSR(
        n_rows=int(z["n_rows"]), n_cols=int(z["n_cols"]),
        row_ptr=z["row_ptr"], dst=z["dst"], src=z["src"], vals=z["vals"],
    )
    masks = {k: z[f"mask_{k}"] for k in ("train", "val", "test")}
    return g, z["feats"], z["labels"], masks


def _cache_save(path: str, data) -> None:
    g, feats, labels, masks = data
    tmp = path + ".tmp.npz"
    np.savez(
        tmp, n_rows=g.n_rows, n_cols=g.n_cols, row_ptr=g.row_ptr,
        dst=g.dst, src=g.src, vals=g.vals, feats=feats, labels=labels,
        **{f"mask_{k}": v for k, v in masks.items()},
    )
    os.replace(tmp, path)


def load_dataset(
    name: str,
    data_root: str | None = None,
    scale: float = 1.0,
    seed: int = 0,
):
    """Returns (HostCSR, feats, labels, masks)."""
    name = canonical_name(name)
    if data_root:
        path = os.path.join(data_root, name)
        if os.path.exists(os.path.join(path, "Adj_src.npy")):
            return load_gala_npy(path)

    if name in REGISTRY:
        n, e, f, c = REGISTRY[name]
        n = max(int(n * scale), 64)
        e = max(int(e * scale), 256)
        f_eff = f if scale >= 1.0 else min(f, 256)
        # large synthetic stand-ins cache to disk: the generator costs
        # ~2 min at Products-0.25 scale and every evaluate.py job pays
        # it again for the same (name, scale, seed)
        cache = _cache_dir()
        key = None
        if cache and e >= 2_000_000:
            ver = _GEN_VERSION_BY_NAME.get(name, _GEN_VERSION)
            key = os.path.join(
                cache, f"{name}_v{ver}_s{scale:g}_seed{seed}.npz"
            )
            if os.path.exists(key):
                try:
                    return _cache_load(key)
                except Exception:
                    pass  # stale/corrupt cache entry: regenerate
        if name == "RGG2D":
            from gala_tpu.data.synthetic import rgg2d_dataset

            data = rgg2d_dataset(
                n, avg_degree=max(e // max(n, 1), 2), n_feats=f_eff,
                n_classes=c, seed=seed,
            )
        else:
            data = synthetic_like(n, e, f_eff, c, seed=seed)
        if key is not None:
            try:
                os.makedirs(cache, exist_ok=True)
                _cache_save(key, data)
            except OSError:
                pass  # cache is best-effort (read-only FS, disk full)
        return data

    # unknown name: small default synthetic
    return synthetic_dataset(n=512, seed=seed)


def synthetic_like(n: int, e: int, f: int, c: int, seed: int = 0):
    """R-MAT graph with planted-community features/labels at the given
    shape (the generator parity point: reference src/utils/generator.h)."""
    rng = np.random.default_rng(seed)
    src, dst = rmat_edges(n, e, seed=seed)
    labels = rng.integers(0, c, size=n, dtype=np.int64)
    # plant homophily: rewire most edges to same-class endpoints so the
    # graph signal is informative (real citation/social graphs are
    # homophilous; without this the accuracy oracle is meaningless)
    rewire = rng.random(src.shape[0]) < 0.7
    members = [np.flatnonzero(labels == k) for k in range(c)]
    dst = dst.copy()
    for k in range(c):
        sel = rewire & (labels[src] == k)
        if members[k].size:
            dst[sel] = rng.choice(members[k], size=int(sel.sum()))
    src, dst = symmetrize(src, dst, n)
    src, dst = normalize_self_loops(src, dst, n)
    g = coo_to_csr(src, dst, None, n_rows=n)
    feats = rng.normal(0.0, 1.0, size=(n, f)).astype(np.float32)
    feats[np.arange(n), labels % f] += 2.0

    perm = rng.permutation(n)
    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[perm[: int(0.3 * n)]] = True
    val_mask[perm[int(0.3 * n) : int(0.5 * n)]] = True
    test_mask[perm[int(0.5 * n) :]] = True
    return g, feats, labels, {"train": train_mask, "val": val_mask, "test": test_mask}
