"""Structure-of-arrays HNSW graph of the port, built by its native builder.

    vectors          (N, d)    float32  the rows
    levels           (N,)      int32    each vertex's top level (0-based)
    neighbors0       (N, 2M)   int32    layer-0 lists, -1 padded
    upper_row        (N,)      int32    row into upper_neighbors, -1 on level 0
    upper_neighbors  (U, L, M) int32    lists of levels 1..L, -1 padded
    entry_point / top_level              scalars

Vertex ids are row indices. The layout and the builder are those of
``shine_tpu/graph/soa.py``, so that a graph built or saved by either
package serves in the other. ``host_search`` is the native k-NN over a graph
on the host, the semantic oracle that the batched search on the card is held
to; ``estimate_index_bytes`` the expected size of an index.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from shine_tpu_torch import native
from shine_tpu_torch.config import HNSWParams

_FIELDS = ("vectors", "levels", "neighbors0", "upper_row", "upper_neighbors")


@dataclasses.dataclass
class GraphSoA:
    params: HNSWParams
    vectors: np.ndarray
    levels: np.ndarray
    neighbors0: np.ndarray
    upper_row: np.ndarray
    upper_neighbors: np.ndarray
    entry_point: int
    top_level: int

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def level_cap(self) -> int:
        return self.upper_neighbors.shape[1]

    def validate(self) -> None:
        """Raise AssertionError unless the graph keeps its invariants (the
        JAX package's ``GraphSoA.validate``): list shapes, ids in range, no
        self-loop on layer 0, upper rows exactly for the vertices above
        level 0, every level-l edge to a vertex that reaches level l, the
        entry point on the top level."""
        n = self.n
        M, M0 = self.params.M_max, self.params.M_max0
        assert self.neighbors0.shape == (n, M0)
        assert self.levels.min() >= 0 and self.levels.max() == self.top_level
        assert 0 <= self.entry_point < n
        assert self.levels[self.entry_point] == self.top_level
        nb = self.neighbors0
        assert nb.max() < n
        rows = np.broadcast_to(np.arange(n)[:, None], nb.shape)
        assert not np.any((nb >= 0) & (nb == rows)), "self-loop at level 0"
        up = self.upper_row
        assert np.all((up >= 0) == (self.levels > 0))
        used = up[up >= 0]
        assert used.max(initial=-1) < self.upper_neighbors.shape[0]
        assert len(np.unique(used)) == len(used)
        for l in range(1, self.top_level + 1):
            ids = np.where(self.levels >= l)[0]
            ls = self.upper_neighbors[up[ids], l - 1]
            ok = (ls < 0) | ((ls < n) & (self.levels[np.clip(ls, 0, n - 1)] >= l))
            assert ok.all(), f"level-{l} edge to a lower-level node"
        assert self.upper_neighbors.shape[2] == M

    @classmethod
    def from_fields(cls, graph) -> "GraphSoA":
        """Copy any object with this class's fields (the JAX package's
        ``GraphSoA``, for one) field by field, as numpy arrays."""
        p = graph.params
        return cls(
            params=HNSWParams(M=p.M, ef_construction=p.ef_construction,
                              metric=p.metric, seed=p.seed),
            **{f: np.array(getattr(graph, f)) for f in _FIELDS},
            entry_point=int(graph.entry_point),
            top_level=int(graph.top_level),
        )


def build_graph(
    vectors: np.ndarray,
    params: HNSWParams,
    *,
    threads: int = 0,
    level_cap: int = 12,
) -> GraphSoA:
    """Build with the native multithreaded builder (the reference's insert
    semantics). Only ``threads=1`` is deterministic."""
    lib = native.load()
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 32)
    M = params.M
    # the expected share of vertices above level 0 is 1/M under the
    # geometric draw; 4x headroom plus a constant floor
    upper_cap = int(4 * n / max(M, 2)) + 1024
    levels = np.empty(n, dtype=np.int32)
    neighbors0 = np.empty((n, 2 * M), dtype=np.int32)
    upper_row = np.empty(n, dtype=np.int32)
    upper_neighbors = np.empty((upper_cap, level_cap, M), dtype=np.int32)
    meta = np.zeros(3, dtype=np.int64)
    rc = lib.shine_hnsw_build(
        vectors, n, d, M, params.ef_construction, params.seed,
        params.metric_id, threads, upper_cap, level_cap, levels, neighbors0,
        upper_row, upper_neighbors.reshape(-1), meta,
    )
    if rc != 0:
        raise RuntimeError("upper-row capacity overflow during build")
    entry_point, top_level, used = int(meta[0]), int(meta[1]), int(meta[2])
    # keep the used upper rows, trimmed to top_level levels
    lcap = max(top_level, 1)
    upper_neighbors = np.ascontiguousarray(upper_neighbors[:used, :lcap])
    return GraphSoA(
        params=params,
        vectors=vectors,
        levels=levels,
        neighbors0=neighbors0,
        upper_row=upper_row,
        upper_neighbors=upper_neighbors,
        entry_point=entry_point,
        top_level=top_level,
    )


def host_search(
    graph: GraphSoA,
    queries: np.ndarray,
    k: int,
    ef: int,
    *,
    threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Native k-NN over the graph on the host (the reference's knn,
    hnsw.hh:253-307): a greedy descent of the upper levels, then a search of
    layer 0 bounded by ``ef``, ties broken by the smaller id. Each query runs
    on one thread, so the answer does not depend on ``threads`` (0 = up to
    32 cores). Returns (ids (nq, k) int32, -1 padded; distances (nq, k) f32,
    +inf padded)."""
    lib = native.load()
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 32)
    results = np.empty((nq, k), dtype=np.int32)
    dists = np.empty((nq, k), dtype=np.float32)
    lib.shine_hnsw_search(
        np.ascontiguousarray(graph.vectors, np.float32), graph.n, graph.dim,
        graph.params.M, graph.params.metric_id,
        np.ascontiguousarray(graph.levels, np.int32),
        np.ascontiguousarray(graph.neighbors0, np.int32),
        np.ascontiguousarray(graph.upper_row, np.int32),
        np.ascontiguousarray(graph.upper_neighbors, np.int32).reshape(-1),
        graph.level_cap, graph.entry_point, graph.top_level,
        queries, nq, k, ef, threads, results.reshape(-1), dists.reshape(-1),
    )
    return results, dists


def estimate_index_bytes(n: int, d: int, params: HNSWParams) -> int:
    """Expected index size under the geometric level distribution (the
    reference's estimate_index_size, hnsw.hh:309-321): each vertex's row,
    level, upper row and layer-0 list, plus the upper lists of the 1/(M-1)
    share of vertices above level 0, times e."""
    M = params.M
    per_node = d * 4 + 4 + 4 + 2 * M * 4  # vector + level + upper_row + L0
    upper_frac = 1.0 / (M - 1)  # sum of P(level >= l) for l >= 1
    per_upper = params.M_max * 4
    return int(n * (per_node + upper_frac * per_upper * math.e))
