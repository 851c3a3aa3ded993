"""Query-to-shard placement and k-means: the port of
``shine_tpu/parallel/placement.py`` (the reference's placement.hh and
kmeans.hh:93-197).

``_lloyd`` is plain Lloyd k-means from a farthest-point initialisation.
The routed build orders its clusters in space with it, and draws the first
centre from a ``torch.Generator`` seeded with ``seed`` on the CPU
(``_draw_first``): a seed gives the same centre on the CPU and on the card,
but not the JAX package's centre.

``kmeans`` adds the balanced refinement (``capacity_assign``, three rounds)
and draws its first centre as the JAX package does,
``jax.random.randint(PRNGKey(seed), (), 0, n)``, through the port's
threefry (``ops/threefry.py``, bit for bit). ``Placement`` runs it over the
graph's highest levels, so that one graph plans the same shards in both
packages. It plans on the host, as the router that reads it does.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2
from shine_tpu_torch.ops import threefry
from shine_tpu_torch.ops.distance import cluster_sums, pairwise_distance

KMEANS_SEED = 1234  # the reference's fixed seed (kmeans.hh:169)


def _draw_first(n: int, seed: int) -> int:
    """The seeded index of the first centre, in [0, n)."""
    gen = torch.Generator().manual_seed(seed)
    return int(torch.randint(0, n, (), generator=gen))


def _init_centroids(points: torch.Tensor, k: int, seed: int,
                    first: int | None = None) -> torch.Tensor:
    """Farthest-point init: a seeded first point (``first`` if given), then
    repeatedly the point farthest (squared L2) from the centres chosen so
    far, the first such point on a tie."""
    if first is None:
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


def _lloyd(points: torch.Tensor, *, k: int, iters: int, seed: int,
           first: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations from the farthest-point init, one (n, k)
    distance tile each; an empty cluster keeps its centre; the sums are
    ``cluster_sums``', the same on every run. Returns
    (centroids (k, d) f32, assignment (n,) int32)."""
    points = points.to(torch.float32)
    cents = _init_centroids(points, k, seed, first)
    for _ in range(iters):
        assign = torch.argmin(pairwise_distance(points, cents, METRIC_L2), dim=1)
        sums, counts = cluster_sums(points, assign, k)
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    assign = torch.argmin(pairwise_distance(points, cents, METRIC_L2), dim=1)
    return cents, assign.to(torch.int32)


def capacity_assign(d: np.ndarray, cap: int) -> np.ndarray:
    """Deterministic capacity-constrained assignment: each point goes to its
    nearest centroid that still has room (<= cap points each), points taken
    nearest-first per cluster (the JAX package's replacement for the
    reference's penalty-based balanced k-means, kmeans.hh:259-377)."""
    n, k = d.shape
    ranked = np.argsort(d, axis=1, kind="stable")  # (n, k) choices
    assign = np.full(n, -1, dtype=np.int32)
    room = np.full(k, cap, dtype=np.int64)
    for r in range(k):
        un = assign < 0
        if not un.any():
            break
        choice = ranked[:, r]
        for c in range(k):
            if room[c] <= 0:
                continue
            cand = np.where(un & (choice == c))[0]
            if len(cand) == 0:
                continue
            take = cand[np.argsort(d[cand, c], kind="stable")[: room[c]]]
            assign[take] = c
            room[c] -= len(take)
            un[take] = False
    assert (assign >= 0).all(), "capacity too small for point count"
    return assign


def _host_distance(queries: np.ndarray, points: np.ndarray) -> np.ndarray:
    """The (B, N) squared-L2 tile of ``pairwise_distance`` on the CPU."""
    return pairwise_distance(
        torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)),
        torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)),
    ).numpy()


def kmeans(points: np.ndarray | torch.Tensor, *, k: int, iters: int = 100,
           balanced: bool = True, seed: int = KMEANS_SEED
           ) -> tuple[np.ndarray, np.ndarray]:
    """(centroids (k, d) f32, assignment (n,) int32) on the host. The first
    centre is JAX's draw for ``seed``; ``balanced`` caps every cluster at
    ceil(n / k) points through ``capacity_assign`` and refines the
    centroids under that cap for three rounds."""
    pts_t = torch.as_tensor(points, dtype=torch.float32).cpu()
    n = pts_t.shape[0]
    first = int(threefry.randint(threefry.prng_key(seed), (), 0, n))
    cents, assign = _lloyd(pts_t, k=k, iters=iters, seed=seed, first=first)
    cents, assign = cents.numpy().copy(), assign.numpy()
    if not balanced:
        return cents, assign
    pts = pts_t.numpy()
    cap = -(-n // k)
    for _ in range(3):  # constrained refinement rounds
        a = capacity_assign(_host_distance(pts, cents), cap)
        for c in range(k):
            sel = a == c
            if sel.any():
                cents[c] = pts[sel].mean(axis=0)
    return cents, a


class Placement:
    """Centroid table mapping queries to shards, from the graph's highest
    levels: levels are taken top down until they hold ``min_points``
    vertices (the reference fetches levels until 500, placement.hh:78-106)."""

    def __init__(self, graph, num_shards: int, *, min_points: int = 500):
        levels = graph.levels
        lvl = int(levels.max())
        sel = levels >= lvl
        while lvl > 1 and sel.sum() < min_points:
            lvl -= 1
            sel = levels >= lvl
        pts = graph.vectors[sel]
        if pts.shape[0] < num_shards:
            pts = graph.vectors[: max(num_shards, min(graph.n, min_points))]
        self.centroids, _ = kmeans(pts, k=num_shards, iters=50)
        self.num_shards = num_shards

    def closest_shards(self, queries: np.ndarray) -> np.ndarray:
        """(q, num_shards) shard ids, nearest centroid first (placement.hh:
        63-72)."""
        d = _host_distance(queries, self.centroids)
        return np.argsort(d, axis=1, kind="stable").astype(np.int32)

    def shard_of(self, queries: np.ndarray) -> np.ndarray:
        d = _host_distance(queries, self.centroids)
        return np.argmin(d, axis=1).astype(np.int32)
