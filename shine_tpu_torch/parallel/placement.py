"""Plain Lloyd k-means with farthest-point initialisation: the port of
``_init_centroids`` and ``_lloyd`` in ``shine_tpu/parallel/placement.py``
(the reference's kmeans.hh:93-197), which the routed build uses to order
its clusters in space.

The JAX package draws the first centre with ``jax.random``; the port draws
it from a ``torch.Generator`` seeded with ``seed`` on the CPU
(``_draw_first``), so a seed gives the same centre on the CPU and on the
card, but not the JAX package's centre.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.config import METRIC_L2
from shine_tpu_torch.ops.distance import cluster_sums, pairwise_distance


def _draw_first(n: int, seed: int) -> int:
    """The seeded index of the first centre, in [0, n)."""
    gen = torch.Generator().manual_seed(seed)
    return int(torch.randint(0, n, (), generator=gen))


def _init_centroids(points: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """Farthest-point init: a seeded first point, then repeatedly the point
    farthest (squared L2) from the centres chosen so far, the first such
    point on a tie."""
    first = _draw_first(points.shape[0], seed)
    cents = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                        device=points.device)
    cents[0] = points[first]
    mind = ((points - points[first][None, :]) ** 2).sum(dim=1)
    for i in range(1, k):
        nxt = int(torch.argmax(mind))
        cents[i] = points[nxt]
        mind = torch.minimum(mind, ((points - points[nxt][None, :]) ** 2).sum(dim=1))
    return cents


def _lloyd(points: torch.Tensor, *, k: int, iters: int, seed: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations from the farthest-point init, one (n, k)
    distance tile each; an empty cluster keeps its centre; the sums are
    ``cluster_sums``', the same on every run. Returns
    (centroids (k, d) f32, assignment (n,) int32)."""
    points = points.to(torch.float32)
    cents = _init_centroids(points, k, seed)
    for _ in range(iters):
        assign = torch.argmin(pairwise_distance(points, cents, METRIC_L2), dim=1)
        sums, counts = cluster_sums(points, assign, k)
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    assign = torch.argmin(pairwise_distance(points, cents, METRIC_L2), dim=1)
    return cents, assign.to(torch.int32)
