"""Dataset container and the synthetic generator, as in
``shine_tpu/io/datasets.py``: the same seed gives the same arrays in both
packages. The generator draws a mixture of Gaussians, so that a graph sees
non-uniform neighbourhoods, and queries near base points.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
