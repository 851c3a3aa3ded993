"""IVF over a cluster-sharded layout: the port of
``shine_tpu/parallel/ivf_sharded.py``.

The cluster blocks of an IVF layout (``models/ivf.py``) are dealt
round-robin over the mesh: cluster c lives on shard ``c % S`` in local slot
``c // S``, so that each query's probes, which are spatially contiguous,
spread over the shards. Every shard derives the same (B, p) probe plan from
the replicated centroids (computed once a device), scores the probed rows
it owns, keeps its best ``rerank * k``, and the shards' survivor lanes meet
in one ``all_gather`` and a (dist, id) sort. The exact f32 re-rank of the
survivors runs on the host in numpy against the base kept there, as in the
JAX package: no f32 copy of the base lives on a device.

``search`` packs each shard's owned probes into PL = ceil(2p / S) lanes a
query (``probe_lanes="compact"``) and serves the overflow in further rounds
until no shard has a probe pending; the JAX package loops on the device
while a ``psum`` of the pending flags is positive, the port reads that sum
once a round (``ShardMesh.host_sum``, counted in ``mesh.readbacks``).
``probe_lanes="dense"`` scans all p lanes on every shard, masked to the
owned ones. Both score the probed rows through K1's ``gather_score``
(``ops/distance.py:pair_dots``) on the shard's bf16 blocks, as
``ivf_search`` does: on the card one (query, row) pair has one sum order
whatever the shard count, the lane packing or the batch. ``search_routed``
serves tile-shared grants (``models/ivf.py:_route_cols``) the same way, each
shard compacting the granted clusters it owns, scored as
``ivf_routed_search`` scores them.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.models.ivf import (
    _route_cols,
    _scores,
    _widened,
    affinity_order,
    build_ivf_layout,
)
from shine_tpu_torch.ops.classmax import top_k
from shine_tpu_torch.ops.distance import pair_dots, pairwise_distance, query_sqnorms
from shine_tpu_torch.parallel.flat_sharded import merge_topk
from shine_tpu_torch.parallel.mesh import ShardMesh

SLACK = 2.0  # compact lanes: PL = ceil(slack * p / S)


def _fold(bd, bi, dd, ids, kk: int):
    """Fold new lanes into a running top-kk (lax.top_k's order)."""
    md = torch.cat([bd, dd], -1)
    mi = torch.cat([bi, ids], -1)
    sel = top_k(-md, kk)[1]
    return torch.gather(md, -1, sel), torch.gather(mi, -1, sel)


def _compact(pending: torch.Tensor, local: torch.Tensor, PL: int):
    """Pack each row's first PL pending entries into PL lanes: (take, the
    lanes' local clusters (rows, PL), their valid flags)."""
    rank = torch.cumsum(pending.to(torch.int32), dim=1) - 1
    take = pending & (rank < PL)
    slot = torch.where(take, rank, PL).to(torch.int64)
    rows = pending.shape[0]
    cols = torch.zeros((rows, PL + 1), dtype=torch.int64, device=pending.device)
    cols.scatter_(1, slot, torch.where(take, local, 0).to(torch.int64))
    valid = torch.zeros((rows, PL + 1), dtype=torch.bool, device=pending.device)
    valid.scatter_(1, slot, take)
    return take, cols[:, :PL], valid[:, :PL]


class ShardedIVFIndex:
    """Cluster-sharded IVF over the shards of ``mesh``."""

    def __init__(self, vectors: np.ndarray, mesh: ShardMesh, *,
                 num_clusters: int | None = None, target_cap: int = 128,
                 metric: str | int = "l2", train_size: int = 100_000,
                 seed: int = 1234):
        """Build the layout (``build_ivf_layout``, on the first shard's
        device) at C rounded up to a multiple of S, deal the clusters
        round-robin, and keep the base on the host for the re-rank."""
        self.metric = metric_id(metric)
        S = mesh.size
        n = vectors.shape[0]
        if num_clusters is None:
            num_clusters = max(8, -(-n // target_cap))
        num_clusters = -(-num_clusters // S) * S
        data = build_ivf_layout(vectors, num_clusters, metric=self.metric,
                                train_size=train_size, seed=seed,
                                device=mesh.devices[0])
        self._place(mesh, data.centroids, data.blocks, data.block_sq,
                    data.block_ids, np.ascontiguousarray(vectors, dtype=np.float32))

    @classmethod
    def from_parts(cls, mesh: ShardMesh, centroids, blocks, block_sq, block_ids,
                   base: np.ndarray, metric: str | int = "l2") -> "ShardedIVFIndex":
        """From a layout's tensors in cluster order ((C, cap, d) bf16 blocks,
        (C, cap) norms and ids, C a multiple of S), dealt round-robin here,
        and the f32 base (n, d) on the host."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self._place(mesh, centroids, blocks, block_sq, block_ids,
                    np.ascontiguousarray(base, dtype=np.float32))
        return self

    def _place(self, mesh, centroids, blocks, block_sq, block_ids, base) -> None:
        S = mesh.size
        C = blocks.shape[0]
        if C % S:
            raise ValueError(f"C={C} is not a multiple of {S} shards")
        self.mesh = mesh
        own = [torch.arange(s, C, S, device=blocks.device) for s in range(S)]
        self.blocks = mesh.put([blocks[o].contiguous() for o in own])
        self.block_sq = mesh.put([block_sq[o].contiguous() for o in own])
        self.block_ids = mesh.put([block_ids[o].contiguous() for o in own])
        self.centroids = mesh.replicate(centroids.to(torch.float32))
        self.C, self.C_loc, self.cap = C, C // S, blocks.shape[1]
        self.base = base
        self.n = base.shape[0]
        self.rpc_rounds = 0  # compact rounds
        self.scanned_lanes = 0  # probe lanes scanned, all shards

    def _probes(self, q: torch.Tensor, p: int) -> list[torch.Tensor]:
        """Each shard's copy of the batch's (B, p) probes, computed once a
        device."""
        return self.mesh.per_device(lambda s: top_k(
            -pairwise_distance(q.to(self.mesh.devices[s]), self.centroids[s],
                               self.metric), p)[1])

    def _score(self, s: int, qb, qn, cols, valid):
        """The rows of shard s's local clusters ``cols`` (B, L), scored for
        their queries: (dists (B, L*cap), ids (B, L*cap), -1 and +inf where
        the lane is not valid)."""
        B, L = cols.shape
        cap = self.cap
        d = self.blocks[s].shape[2]
        slots = torch.arange(cap, dtype=torch.int64, device=cols.device)
        rows = (cols[:, :, None] * cap + slots).reshape(B, L * cap)
        dots = pair_dots(self.blocks[s].view(-1, d), qb, rows)
        sqs = self.block_sq[s][cols].reshape(B, L * cap)
        ids = torch.where(valid[:, :, None], self.block_ids[s][cols], -1)
        ids = ids.reshape(B, L * cap)
        return _scores(dots, qn, sqs, ids, self.metric), ids

    def _search_batch(self, q: torch.Tensor, p: int, kk: int, compact: bool):
        """One replicated batch: the (B, kk) merged survivors, the compact
        rounds and the lanes scanned."""
        S = self.mesh.size
        B = q.shape[0]
        probes = self._probes(q, p)
        qs = self.mesh.replicate(q)
        qbs = self.mesh.per_device(lambda s: qs[s].to(torch.bfloat16).to(torch.float32))
        qns = self.mesh.per_device(lambda s: query_sqnorms(qs[s])[:, None])
        init = [(torch.full((B, kk), torch.inf, device=x.device),
                 torch.full((B, kk), -1, dtype=torch.int32, device=x.device))
                for x in qs]
        if not compact:
            bd, bi = [], []
            for s in range(S):
                mine = (probes[s] % S) == s
                safe = (probes[s] // S).clamp(0, self.C_loc - 1).to(torch.int64)
                dd, ids = self._score(s, qbs[s], qns[s], safe, mine)
                sel = top_k(-dd, kk)[1]
                bd.append(torch.gather(dd, 1, sel))
                bi.append(torch.gather(ids, 1, sel))
            return merge_topk(self.mesh, bd, bi, kk)[1], 0, S * B * p
        PL = max(1, -(-int(p * SLACK) // S))
        pending = [(probes[s] % S) == s for s in range(S)]
        local = [probes[s] // S for s in range(S)]
        state = init
        rounds = 0
        while self.mesh.host_sum([x.any().to(torch.int32) for x in pending]) > 0:
            for s in range(S):
                take, cols, valid = _compact(pending[s], local[s], PL)
                dd, ids = self._score(s, qbs[s], qns[s], cols, valid)
                state[s] = _fold(*state[s], dd, ids, kk)
                pending[s] = pending[s] & ~take
            rounds += 1
        cand = merge_topk(self.mesh, [x[0] for x in state], [x[1] for x in state],
                          kk)[1]
        return cand, rounds, rounds * S * B * PL

    def search(self, queries: np.ndarray, k: int = 10, *, probes: int = 8,
               batch_size: int = 2048, rerank: int = 4,
               probe_lanes: str = "compact") -> tuple[np.ndarray, np.ndarray]:
        """Per-query probed search in batches of ``batch_size`` (the last
        padded with zero rows), the survivors re-ranked exactly on the host:
        (ids (nq, k) int32, dists (nq, k) f32). ``rpc_rounds`` and
        ``scanned_lanes`` accumulate the JAX package's counts."""
        if probe_lanes not in ("compact", "dense"):
            raise ValueError("probe_lanes must be 'compact' or 'dense'")
        nq, d = queries.shape
        p = min(probes, self.C)
        kk = min(max(rerank, 1) * k, p * self.cap)
        batch_size = min(batch_size, max(nq, 1))
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            cand, rounds, lanes = self._search_batch(
                torch.from_numpy(q), p, kk, probe_lanes == "compact")
            self.rpc_rounds += rounds
            self.scanned_lanes += lanes
            out_i[lo:hi], out_d[lo:hi] = self._host_rerank(
                cand[: hi - lo].cpu().numpy(), q[: hi - lo], k)
        return out_i, out_d

    def _host_rerank(self, cand: np.ndarray, q: np.ndarray, k: int):
        """Exact f32 re-rank of the survivors against the host base, ordered
        by (dist, id) with -1 last (the JAX package's numpy)."""
        safe = np.maximum(cand, 0)
        cv = self.base[safe]
        dots = np.einsum("bd,bkd->bk", q, cv)
        if self.metric == METRIC_L2:
            dist = (q * q).sum(-1)[:, None] - 2.0 * dots + (cv * cv).sum(-1)
        else:
            dist = 1.0 - dots
        dist = np.where(cand >= 0, dist, np.inf)
        ordk = np.lexsort((np.where(cand < 0, 2**31 - 1, cand), dist), axis=1)[:, :k]
        return (np.take_along_axis(cand, ordk, axis=1),
                np.take_along_axis(dist, ordk, axis=1))

    def _routed_batch(self, q: torch.Tensor, p: int, kk: int, P: int, T: int):
        """One replicated batch of the tile-shared search: the (B, kk)
        merged survivors in the batch's order."""
        S = self.mesh.size
        B, d = q.shape
        G = B // T
        PL = max(1, -(-int(P * SLACK) // S))
        probes = self._probes(q, p)

        def plan(s):
            perm, inv = affinity_order(probes[s])
            cols = _route_cols(probes[s][perm].reshape(G, T, p), self.C, P)[0]
            qf = q.to(self.mesh.devices[s])[perm].reshape(G, T, d)
            return (inv, cols.to(torch.int64), qf.to(torch.bfloat16).to(torch.float32),
                    (qf * qf).sum(dim=-1)[..., None])

        plans = self.mesh.per_device(plan)
        state, pending, local = [], [], []
        for s, (_, cols, qb, _) in enumerate(plans):
            pending.append((cols < self.C) & ((cols % S) == s))
            local.append(cols // S)
            state.append((torch.full((G, T, kk), torch.inf, device=qb.device),
                          torch.full((G, T, kk), -1, dtype=torch.int32,
                                     device=qb.device)))
        while self.mesh.host_sum([x.any().to(torch.int32) for x in pending]) > 0:
            for s in range(S):
                _, _, qb, qn = plans[s]
                take, ccols, valid = _compact(pending[s], local[s], PL)
                rows = _widened(self.blocks[s], ccols).reshape(G, PL * self.cap, d)
                dots = torch.matmul(qb, rows.transpose(1, 2))  # (G, T, PL*cap)
                ids = torch.where(valid[..., None], self.block_ids[s][ccols], -1)
                ids = ids.reshape(G, 1, PL * self.cap)
                sqs = self.block_sq[s][ccols].reshape(G, 1, PL * self.cap)
                dd = _scores(dots, qn, sqs, ids, self.metric)
                state[s] = _fold(*state[s], dd, ids.expand(G, T, -1), kk)
                pending[s] = pending[s] & ~take
        cand = merge_topk(self.mesh, [x[0].reshape(B, kk) for x in state],
                         [x[1].reshape(B, kk) for x in state], kk)[1]
        return cand[plans[0][0]]

    def search_routed(self, queries: np.ndarray, k: int = 10, *, probes: int = 16,
                      shared: int = 96, tile: int = 64, batch_size: int = 4096,
                      rerank: int = 4) -> tuple[np.ndarray, np.ndarray]:
        """Tile-shared probing over the sharded layout: each tile of
        ``tile`` affinity-sorted queries is granted ``shared`` clusters
        (``_route_cols``), each shard scans the granted clusters it owns
        (PL = ceil(2P / S) lanes a round), and the survivors re-rank exactly
        on the host. No spill: the JAX package's sharded form has none."""
        nq, d = queries.shape
        p = min(probes, self.C)
        P = min(shared, self.C)
        kk = min(max(rerank, 1) * k, P * self.cap)
        batch_size = max(tile, -(-min(batch_size, max(nq, 1)) // tile) * tile)
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            cand = self._routed_batch(torch.from_numpy(q), p, kk, P, tile)
            out_i[lo:hi], out_d[lo:hi] = self._host_rerank(
                cand[: hi - lo].cpu().numpy(), q[: hi - lo], k)
        return out_i, out_d

    def routed_cost_counters(self, nq: int, k: int = 10, *, probes: int = 16,
                             shared: int = 96, tile: int = 64,
                             rerank: int = 4) -> dict:
        """The JAX package's analytic routed cost: the plan replicated on
        every shard, each tile's granted blocks read once by their owners,
        the survivors merged between shards, the re-rank on the host."""
        S = self.mesh.size
        P = min(shared, self.C)
        kk = min(max(rerank, 1) * k, P * self.cap)
        d = self.base.shape[1]
        n_tiles = -(-nq // max(tile, 1))
        return {
            "distance_computations": nq * (self.C * S + P * self.cap * S + kk),
            "scanned_rows": nq * P * self.cap,
            "hbm_gather_bytes": n_tiles * P * self.cap * d * 2 + nq * kk * d * 4,
            "ici_exchange_bytes": nq * d * 4 * (S - 1) + nq * kk * 8 * (S - 1),
        }

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 8,
                      batch_size: int = 2048, rerank: int = 4) -> dict:
        """The JAX package's analytic cost: the centroids scored on every
        shard, each probed block scanned by its owner, the (B, kk) lanes
        merged between shards, the re-rank on the host."""
        S = self.mesh.size
        p = min(probes, self.C)
        kk = min(max(rerank, 1) * k, p * self.cap)
        d = self.base.shape[1]
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * (self.C * S + p * self.cap + kk),
            "scanned_rows": nq * p * self.cap,
            "hbm_gather_bytes": batches * self.C * d * 4 * S
            + nq * (p * self.cap * d * 2 + kk * d * 4),
            "ici_exchange_bytes": nq * d * 4 * (S - 1) + nq * kk * 8 * (S - 1),
        }
