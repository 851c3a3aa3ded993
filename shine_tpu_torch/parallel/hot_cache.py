"""Hot-vertex replica cache: the port of ``shine_tpu/parallel/hot_cache.py``
(the reference's compute-node cache, src/cache/cache.hh and
cooling_table.hh).

The hot vertices' rows (vector and layer-0 list) are replicated on every
shard, so a traversal step that touches them reads its own device instead
of asking the owning shard (``parallel/sharded.py``). The hot set is a
snapshot refreshed between batches from decayed access counts (the
cooling table's ranking, on the host); membership is a binary search over
the sorted hot-id table; admission is the top-H by count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2
from shine_tpu_torch.device import resolve_device


@dataclasses.dataclass
class HotReplica:
    """Replicated hot rows on one device. ``hot_ids`` is sorted ascending;
    pad slots hold int32 max so that the search stays monotone."""

    hot_ids: torch.Tensor  # (H,) int32
    hot_vecs: torch.Tensor  # (H, d) f32 or bf16, as the sharded rows
    hot_sq: torch.Tensor  # (H,) f32 squared norms of the stored rows
    hot_neighbors: torch.Tensor  # (H, 2M) int32

    @property
    def capacity(self) -> int:
        return self.hot_ids.shape[0]

    def to(self, device: torch.device) -> "HotReplica":
        return HotReplica(*(t.to(device) for t in dataclasses.astuple(self)))


def replicate_replica(rep: HotReplica, devices: list[torch.device]
                      ) -> list[HotReplica]:
    """``rep`` on each of ``devices`` (a mesh's), one copy a distinct
    device."""
    copies: dict[torch.device, HotReplica] = {}
    for d in devices:
        if d not in copies:
            copies[d] = rep.to(d)
    return [copies[d] for d in devices]


def select_hot_ids(graph, capacity: int,
                   counts: np.ndarray | None = None) -> np.ndarray:
    """The hot set, sorted: the top ``capacity`` vertices by decayed access
    counts when given, else by layer-0 in-degree with every upper-level
    vertex first (the vertices the reference's cache converges to)."""
    if counts is not None:
        score = counts.astype(np.float64)
    else:
        nb = graph.neighbors0
        score = np.bincount(nb[nb >= 0], minlength=graph.n).astype(np.float64)
        score[graph.levels >= 1] += score.max() + 1  # upper nodes always hot
    capacity = min(capacity, graph.n)
    top = np.argpartition(-score, capacity - 1)[:capacity]
    return np.sort(top).astype(np.int32)


def build_replica(graph, hot_ids: np.ndarray, *, rows: str = "f32",
                  device: torch.device | str | None = None) -> HotReplica:
    """The replica of ``hot_ids`` on ``device`` (the CUDA card unless
    another is given). ``rows`` must be the sharded graph's row storage:
    a hit must serve the values the owner would, so bf16 replicas store
    the rounded rows and the norms of the rounded rows."""
    dev = resolve_device(device)
    vecs = torch.from_numpy(
        np.ascontiguousarray(graph.vectors[hot_ids], dtype=np.float32))
    if rows == "bf16":
        store = vecs.to(torch.bfloat16)
        vecs = store.to(torch.float32)
    elif rows == "f32":
        store = vecs
    else:
        raise ValueError(f"replica rows must be f32|bf16, got {rows!r}")
    v = vecs.numpy()
    sq = (v * v).sum(-1)
    if graph.params.metric_id != METRIC_L2:
        sq = np.zeros_like(sq)
    return HotReplica(
        hot_ids=torch.from_numpy(np.ascontiguousarray(hot_ids, np.int32)).to(dev),
        hot_vecs=store.to(dev),
        hot_sq=torch.from_numpy(sq.astype(np.float32)).to(dev),
        hot_neighbors=torch.from_numpy(
            np.ascontiguousarray(graph.neighbors0[hot_ids])).to(dev),
    )


def replica_lookup(replica: HotReplica, ids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, hit): rows into the replica's tables where hit, else 0. A
    binary search over the sorted id table (the reference walks a hash
    chain, cache.hh:102-144); the replica does not change between
    refreshes, so nothing races."""
    safe = ids.clamp_min(0)
    pos = torch.searchsorted(replica.hot_ids, safe.contiguous())
    pos = pos.clamp_max(replica.capacity - 1)
    hit = (replica.hot_ids[pos] == safe) & (ids >= 0)
    return torch.where(hit, pos, 0), hit


class AccessCounter:
    """Exponentially decayed per-vertex access counts (the cooling table's
    stand-in): counted on the devices, ranked on the host."""

    def __init__(self, n: int, decay: float = 0.5):
        self.counts = np.zeros(n, dtype=np.float64)
        self.decay = decay

    def absorb(self, row_counts: np.ndarray, hot_ids: np.ndarray | None = None,
               hot_counts: np.ndarray | None = None) -> None:
        """Fold one batch's counts into the decayed totals: ``row_counts``
        per global row, counted by the owners (cold traffic), and
        ``hot_counts`` per replica slot (hits keep entries hot, as
        Cache::get rescues cooling entries, cache.hh:128-134)."""
        self.counts *= self.decay
        n = len(self.counts)
        self.counts += np.asarray(row_counts, dtype=np.float64)[:n]
        if hot_ids is not None and hot_counts is not None:
            h = np.asarray(hot_ids)
            valid = h < n  # pad slots hold int32 max
            self.counts[h[valid]] += np.asarray(hot_counts, np.float64)[valid]

    def refresh(self, graph, capacity: int, *, rows: str = "f32",
                device: torch.device | str | None = None) -> HotReplica:
        ids = select_hot_ids(graph, capacity, self.counts)
        return build_replica(graph, ids, rows=rows, device=device)
