"""Dataset container, the synthetic generator and the dataset directories,
as in ``shine_tpu/io/datasets.py``: the same seed gives the same arrays in
both packages, and a directory written by either loads in the other. The
generator draws a mixture of Gaussians, so that a graph sees non-uniform
neighbourhoods, and queries near base points.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from shine_tpu_torch.io.fbin import read_bin, write_bin


@dataclasses.dataclass
class Dataset:
    base: np.ndarray  # (n, d) float32
    queries: np.ndarray  # (q, d) float32
    ground_truth: np.ndarray | None  # (q, k) int32 ids into base
    metric: str = "l2"
    name: str = "synthetic"

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def dim(self) -> int:
        return self.base.shape[1]


def synthetic_dataset(
    n: int = 100_000,
    dim: int = 128,
    num_queries: int = 1_000,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 100,
    compute_gt: bool = True,
) -> Dataset:
    """Mixture-of-Gaussians base set; queries drawn near base points. IP
    sets are normalised, so that 1 - <a, b> acts as an angular distance.
    With ``compute_gt`` the exact top-``gt_k`` comes from the numpy brute
    force."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, num_clusters, size=n)
    base = centers[assign] + rng.normal(size=(n, dim)).astype(np.float32)
    qidx = rng.integers(0, n, size=num_queries)
    queries = base[qidx] + 0.3 * rng.normal(size=(num_queries, dim)).astype(
        np.float32
    )
    base = base.astype(np.float32)
    queries = queries.astype(np.float32)
    if metric == "ip":
        base /= np.linalg.norm(base, axis=1, keepdims=True) + 1e-30
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
    gt = None
    if compute_gt:
        from shine_tpu_torch.io.recall import brute_force_knn

        gt, _ = brute_force_knn(base, queries, gt_k, metric=metric)
    return Dataset(base, queries, gt, metric=metric, name=f"synth-{n}x{dim}")


def save_dataset(ds: Dataset, root: str) -> None:
    """Write the reference's directory layout: base.fbin,
    queries/query.fbin and, with ground truth, groundtruth-query.bin."""
    os.makedirs(os.path.join(root, "queries"), exist_ok=True)
    write_bin(os.path.join(root, "base.fbin"), ds.base)
    write_bin(os.path.join(root, "queries", "query.fbin"), ds.queries)
    if ds.ground_truth is not None:
        write_bin(
            os.path.join(root, "groundtruth-query.bin"),
            ds.ground_truth.astype(np.uint32),
        )


def load_dataset(root: str, *, metric: str = "l2", query_suffix: str = "query") -> Dataset:
    """Read a dataset directory: base.{fbin,u8bin,i8bin}, queries/<suffix>.*
    and, where present, groundtruth-<suffix>.bin. Integer rows widen to
    float32."""
    base = read_bin(_find(root, "base"))
    queries = read_bin(_find(os.path.join(root, "queries"), query_suffix))
    gt_path = os.path.join(root, f"groundtruth-{query_suffix}.bin")
    gt = None
    if os.path.exists(gt_path):
        gt = read_bin(gt_path).astype(np.int32)
    return Dataset(base, queries, gt, metric=metric, name=os.path.basename(root))


def _find(root: str, stem: str) -> str:
    for ext in (".fbin", ".u8bin", ".i8bin"):
        p = os.path.join(root, stem + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {stem}.* under {root}")


# Per-dataset search settings tuned for ~95% recall@10, the reference's
# registry (scripts/datasets.py of the reference) as the JAX package keeps it.
DATASET_REGISTRY: dict[str, dict] = {
    "sift1m": {"dim": 128, "metric": "l2", "ef_search": 100},
    "turing1m": {"dim": 100, "metric": "l2", "ef_search": 100},
    "turing100m": {"dim": 100, "metric": "l2", "ef_search": 150},
    "tti10m": {"dim": 200, "metric": "ip", "ef_search": 250},
    "tti100m": {"dim": 200, "metric": "ip", "ef_search": 250},
    "deep100m": {"dim": 96, "metric": "l2", "ef_search": 100},
    "spacev100m": {"dim": 100, "metric": "l2", "ef_search": 100},
    "bigann100m": {"dim": 128, "metric": "l2", "ef_search": 80},
    "gist1m": {"dim": 960, "metric": "l2", "ef_search": 128},
}


def dataset_defaults(name: str) -> dict:
    try:
        return DATASET_REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}"
        ) from None
