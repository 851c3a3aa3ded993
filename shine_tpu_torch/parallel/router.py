"""Skew-aware query routing, the port of ``shine_tpu/parallel/router.py``
(the reference's QueryRouter, src/router/query_router.hh): host numpy,
copied as it is, so that one placement gives the same plans in both
packages.

On a mesh every shard reaches every other, so the reference's relay
machinery has no counterpart; what remains is batch composition. The
router orders the query stream so that slice s of each batch holds the
queries nearest shard s's region (query b lands on shard b // B_loc), and
keeps the per-shard load balanced under Zipf skew with per-batch quotas
(``AdaptiveQueryRouter``: the reference's ADAPTIVE_ROUTING update_limits,
query_router.hh:106-151). Routing permutes queries only: unpermuted
results equal the unrouted ones.
"""

from __future__ import annotations

import numpy as np

from shine_tpu_torch.parallel.placement import Placement


class QueryRouter:
    """Permutes a query stream into shard-affine, load-balanced batches."""

    def __init__(
        self,
        placement: Placement,
        *,
        batch_size: int,
        balanced: bool = True,
    ):
        self.placement = placement
        self.num_shards = placement.num_shards
        if batch_size % self.num_shards:
            raise ValueError("batch_size must be divisible by num_shards")
        self.batch_size = batch_size
        self.per_shard = batch_size // self.num_shards
        self.balanced = balanced

    def plan(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (perm, batch_shard) where perm is a permutation of query
        indices grouped into consecutive batches of `batch_size`, laid out
        so that slice s of each batch holds queries affine to shard s;
        batch_shard (num_batches, num_shards) records the backlog-adjusted
        quota actually used (for stats).

        Queries overflowing their affine shard's quota spill to the ranked
        next-closest shard with room — the balanced-routing histogram walk
        (query_router.hh:353-370).
        """
        nq = queries.shape[0]
        ranked = self.placement.closest_shards(queries)  # (nq, S)
        S, P = self.num_shards, self.per_shard
        num_batches = -(-nq // self.batch_size)
        # Fully vectorized (the per-query Python loop of the first version
        # was 50x too slow at the reference's 500k-query workloads):
        # group queries by primary shard keeping arrival (FIFO) order; the
        # r-th query of shard s fills batch r//P, lane slot s*P + r%P.
        primary = ranked[:, 0].astype(np.int64)
        order = np.argsort(primary, kind="stable")
        sp = primary[order]
        start = np.searchsorted(sp, np.arange(S))
        rank = np.arange(nq, dtype=np.int64) - start[sp]
        batch_idx = rank // P
        fits = batch_idx < num_batches
        slot = batch_idx * self.batch_size + sp * P + rank % P
        perm = np.full(num_batches * self.batch_size, -1, dtype=np.int64)
        perm[slot[fits]] = order[fits]
        used = np.bincount(
            (batch_idx[fits] * S + sp[fits]), minlength=num_batches * S
        ).reshape(num_batches, S).astype(np.int32)
        # spill over-quota queries into the remaining holes (shard-grouped
        # FIFO order — the balanced-routing histogram walk's overflow path,
        # query_router.hh:353-370)
        remaining = order[~fits]
        holes = np.where(perm < 0)[0]
        if len(remaining) > len(holes):
            raise AssertionError("router lost queries")  # conservation check
        perm[holes[: len(remaining)]] = remaining
        perm[holes[len(remaining):]] = nq  # sentinel: caller pads
        return perm, used

    @staticmethod
    def apply(
        queries: np.ndarray, perm: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Materialize the routed query tensor; sentinel rows (== nq) are
        zero-padded. Returns (routed (len(perm), d), valid mask)."""
        nq, d = queries.shape
        valid = perm < nq
        routed = np.zeros((len(perm), d), dtype=queries.dtype)
        routed[valid] = queries[perm[valid]]
        return routed, valid

    @staticmethod
    def unpermute(results: np.ndarray, perm: np.ndarray, nq: int) -> np.ndarray:
        """Scatter batched results back to original query order."""
        out = np.empty((nq,) + results.shape[1:], dtype=results.dtype)
        valid = perm < nq
        out[perm[valid]] = results[valid]
        return out


class AdaptiveQueryRouter:
    """Cross-batch adaptive quota routing (reference update_limits,
    query_router.hh:106-151, invoked per batch at :315-316).

    Where QueryRouter composes every batch up front with static per-slice
    quotas, this router emits batches one at a time and *observes* the
    per-slice traversal load (summed beam hops) of each served batch. The
    next batch's affine quota per slice is proportional to its relative
    idleness — slices that carried heavy queries get fewer affine
    placements and more of their lanes become spill lanes, and spill
    prefers the idlest slices. Pure batch composition: a permutation of the
    query stream, so unpermuted results are exactly the unrouted results.

    (The shards step in lockstep and a batch ends when all its lanes
    converge, so the quota mechanism shapes locality and straggler mix
    rather than queue depth: the measurable analogue of the reference's
    per-CN occupancy is the per-slice hops load, which this narrows under
    Zipf skew.)"""

    def __init__(
        self,
        placement: Placement,
        *,
        batch_size: int,
        ema: float = 0.5,
    ):
        self.placement = placement
        self.num_shards = placement.num_shards
        if batch_size % self.num_shards:
            raise ValueError("batch_size must be divisible by num_shards")
        self.batch_size = batch_size
        self.per_shard = batch_size // self.num_shards
        self.ema = ema
        self.load = np.ones(self.num_shards, dtype=np.float64)
        self.quota_history: list[np.ndarray] = []
        self.load_history: list[np.ndarray] = []  # per-slice hops per batch

    def start(self, queries: np.ndarray) -> None:
        """Build per-shard FIFO backlogs in affinity order."""
        ranked = self.placement.closest_shards(queries)
        primary = ranked[:, 0].astype(np.int64)
        self.order = np.argsort(primary, kind="stable")
        sp = primary[self.order]
        S = self.num_shards
        self.heads = np.searchsorted(sp, np.arange(S)).astype(np.int64)
        self.ends = np.searchsorted(sp, np.arange(S), side="right").astype(
            np.int64
        )
        self.nq = len(queries)
        self.emitted = 0

    def _quotas(self) -> np.ndarray:
        """Affine slots per slice for the next batch ∝ relative idleness,
        capped at the physical slice width (update_limits:106-151)."""
        idle = 1.0 / np.maximum(self.load, 1e-9)
        q = np.floor(idle / idle.sum() * self.batch_size).astype(np.int64)
        return np.minimum(q, self.per_shard)

    def next_batch(self) -> np.ndarray | None:
        """Returns the next batch's perm slice ((batch_size,), sentinel nq
        pads) or None when the stream is exhausted."""
        S, P = self.num_shards, self.per_shard
        remaining = self.ends - self.heads
        if remaining.sum() == 0:
            return None
        perm_b = np.full(self.batch_size, -1, dtype=np.int64)
        quotas = self._quotas()
        self.quota_history.append(quotas.copy())
        for s in range(S):
            take = int(min(quotas[s], remaining[s], P))
            if take:
                perm_b[s * P : s * P + take] = self.order[
                    self.heads[s] : self.heads[s] + take
                ]
                self.heads[s] += take
        # spill: fill remaining lanes from the largest backlogs, placing
        # into the idlest slices' holes first
        holes = np.where(perm_b < 0)[0]
        hole_slices = holes // P
        holes = holes[np.argsort(self.load[hole_slices], kind="stable")]
        filled = 0
        for s in np.argsort(-(self.ends - self.heads), kind="stable"):
            if filled == len(holes):
                break
            take = int(min(self.ends[s] - self.heads[s], len(holes) - filled))
            if take:
                perm_b[holes[filled : filled + take]] = self.order[
                    self.heads[s] : self.heads[s] + take
                ]
                self.heads[s] += take
                filled += take
        perm_b[perm_b < 0] = self.nq  # sentinel: caller pads
        self.emitted += 1
        return perm_b

    def observe(self, hops: np.ndarray) -> None:
        """Feed back the served batch's per-query hops ((batch_size,) in
        lane order; pad lanes contribute 0) — the ack-message progress
        exchange of the reference (message_wrapper.hh:22-41)."""
        per_slice = hops.reshape(self.num_shards, self.per_shard).sum(axis=1)
        self.load_history.append(per_slice.astype(np.float64))
        norm = per_slice / max(per_slice.mean(), 1e-9)
        self.load = self.ema * self.load + (1.0 - self.ema) * norm
