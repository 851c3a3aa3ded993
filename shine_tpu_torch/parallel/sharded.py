"""Sharded HNSW search over a one-process shard mesh: the port of
``shine_tpu/parallel/sharded.py``.

SHINE keeps the graph and the vectors in passive memory nodes that compute
nodes read by one-sided RDMA (the reference's src/memory_node.hh,
src/compute_node.cc). Here every shard holds one row range of the layer-0
graph (the memory node's role) and advances one slice of the query batch
(the compute node's). A remote read becomes the owner-computed exchange,
twice a traversal step:

  1. frontier lists: each frontier id goes to the shard that owns its row,
     which sends the layer-0 list back;
  2. candidate distances: the query batch is replicated once, so the owner
     of each candidate row scores it against the query and only one float
     a candidate travels back; rows never move.

Each exchange runs dense (``all_gather`` the ids, every shard answers the
ids it owns, ``psum_scatter`` the answers back) or compact (``_owner_rpc``:
fixed-size buckets through ``all_to_all``, each id travelling once to its
owner, in rounds until every shard is served). The upper levels are
replicated, so the entry (the dense sweep or the greedy descent) needs no
exchange but the entry distance's. A hot-vertex replica
(``parallel/hot_cache.py``) serves the lists and distances of its ids on
the asking shard, and the owners skip those lanes.

Every distance is scored by K1's ``gather_score`` (``csrc/gather_score.cu``
on a card), which sums each (query, row) pair in one order whatever the
call's shape. The dense and the compact payloads, the replica's hits, every
shard count and the dense entry's seeds (rescored after the sweep picks
them) therefore give the same ids and distance bits. The beam merge runs
through ``ops/beam.py``. Where the JAX package sums zeros from the
non-owners (``psum_scatter``), the port masks the non-owners to zero
before the same sum, so K1's inf on a masked lane is never added.

The shards step in lockstep, as ``shard_map`` does: the loop of steps and
each exchange's loop of rounds read one flag of all shards to the host
(``ShardMesh.host_sum``), counted in ``ShardedIndex.readbacks``.

Global ids are rows; the owner of id i is shard i // rows_per_shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, SearchParams
from shine_tpu_torch.models.hnsw import _extend_query, dense_entry_positions
from shine_tpu_torch.ops.beam import (
    beam_frontier_multi,
    beam_init,
    beam_mark_expanded,
    beam_merge,
)
from shine_tpu_torch.ops.gather_score import gather_score
from shine_tpu_torch.parallel.hot_cache import (
    AccessCounter,
    HotReplica,
    build_replica,
    replica_lookup,
    replicate_replica,
    select_hot_ids,
)
from shine_tpu_torch.parallel.mesh import ShardMesh
from shine_tpu_torch.parallel.placement import Placement
from shine_tpu_torch.parallel.router import AdaptiveQueryRouter, QueryRouter

ID_MAX = 2**31 - 1


@dataclasses.dataclass
class ShardedGraph:
    """The sharded index on a mesh: per-shard lists.

    Row-sharded (shard s holds global rows [s * rows, (s + 1) * rows)):
      vectors (rows, d) f32|bf16, vec_sqnorms (rows,) f32 (inf on pad rows),
      neighbors0 (rows, 2M) int32 (-1 pad)
    Replicated (one copy a device, u-indices are rows of these tables):
      upper_ids (U,) global id of each upper vertex, upper_vecs (U, d) f32,
      upper_sqnorms (U,), upper_adj (U, L, M) u-indices (-1 pad)
    and ``entry_u``, the entry point's u-index. The norms are the JAX
    package's layout, which ``convert.sharded_graph_from_jax`` carries; the
    search does not read them, as K1 computes each row's norm from the row.
    """

    vectors: list[torch.Tensor]
    vec_sqnorms: list[torch.Tensor]
    neighbors0: list[torch.Tensor]
    upper_ids: list[torch.Tensor]
    upper_vecs: list[torch.Tensor]
    upper_sqnorms: list[torch.Tensor]
    upper_adj: list[torch.Tensor]
    entry_u: int

    @property
    def rows_per_shard(self) -> int:
        return self.vectors[0].shape[0]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * len(self.vectors)

    @property
    def top_level(self) -> int:
        return self.upper_adj[0].shape[1]


def _pad_rows(a: np.ndarray, n_to: int, fill) -> np.ndarray:
    if a.shape[0] == n_to:
        return a
    pad = np.full((n_to - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def build_upper_tables(graph) -> tuple[np.ndarray, np.ndarray, int]:
    """(upper_ids (U,), upper_adj (U, L, M) in u-indices, entry_u): the
    upper levels rebased from global ids onto the upper-vertex table, so
    that the descent never reads the sharded tables."""
    upper_ids = np.where(graph.levels >= 1)[0].astype(np.int32)
    u_of_global = np.full(graph.n, -1, dtype=np.int32)
    u_of_global[upper_ids] = np.arange(len(upper_ids), dtype=np.int32)
    rows = graph.upper_row[upper_ids]
    adj_global = graph.upper_neighbors[rows]  # (U, L, M) global ids
    adj_u = np.where(
        adj_global >= 0, u_of_global[np.clip(adj_global, 0, graph.n - 1)], -1
    ).astype(np.int32)
    entry_u = int(u_of_global[graph.entry_point])
    assert entry_u >= 0
    return upper_ids, adj_u, entry_u


def _host_rows(graph, rows: str) -> tuple[torch.Tensor, np.ndarray]:
    """(stored rows, their f32 values): bf16 rows are rounded once here so
    that every norm is the rounded row's."""
    v = torch.from_numpy(np.ascontiguousarray(graph.vectors, dtype=np.float32))
    if rows == "f32":
        return v, v.numpy()
    if rows == "bf16":
        store = v.to(torch.bfloat16)
        return store, store.to(torch.float32).numpy()
    raise ValueError(
        f"sharded rows must be f32|bf16, got {rows!r} (int8 is "
        "single-chip capacity-only: models/hnsw.py)"
    )


def shard_graph(graph, mesh: ShardMesh, *, rows: str = "f32") -> ShardedGraph:
    """Pad the graph to the shard grid and place it on the mesh. ``rows``
    is the layer-0 row storage, f32 or bf16 (norms of the rounded rows);
    the replicated upper tables stay f32."""
    S = mesh.size
    n = graph.n
    per = -(-n // S)
    n_pad = per * S
    store, host_v = _host_rows(graph, rows)
    sq = (host_v ** 2).sum(axis=1)
    if graph.params.metric_id != METRIC_L2:
        sq = np.zeros_like(sq)
    sq = _pad_rows(sq.astype(np.float32), n_pad, np.inf)
    nbrs0 = _pad_rows(np.ascontiguousarray(graph.neighbors0), n_pad, -1)
    if n_pad != n:
        store = torch.cat([store, torch.zeros((n_pad - n, store.shape[1]),
                                              dtype=store.dtype)])
    upper_ids, adj_u, entry_u = build_upper_tables(graph)
    upper_vecs = np.ascontiguousarray(graph.vectors[upper_ids], dtype=np.float32)
    upper_sq = (upper_vecs ** 2).sum(axis=1)
    if graph.params.metric_id != METRIC_L2:
        upper_sq = np.zeros_like(upper_sq)

    def cut(t: torch.Tensor) -> list[torch.Tensor]:
        return mesh.put([t[s * per:(s + 1) * per].clone() for s in range(S)])

    return ShardedGraph(
        vectors=cut(store),
        vec_sqnorms=cut(torch.from_numpy(sq)),
        neighbors0=cut(torch.from_numpy(nbrs0)),
        upper_ids=mesh.replicate(torch.from_numpy(upper_ids)),
        upper_vecs=mesh.replicate(torch.from_numpy(upper_vecs)),
        upper_sqnorms=mesh.replicate(torch.from_numpy(upper_sq.astype(np.float32))),
        upper_adj=mesh.replicate(torch.from_numpy(adj_u)),
        entry_u=entry_u,
    )


def _upper_descent(mesh: ShardMesh, g: ShardedGraph, q_ext: list, bias: list,
                   l2: bool) -> list[torch.Tensor]:
    """Greedy 1-NN walk down the replicated upper levels for every shard's
    query slice: the layer-0 entry's global id per query. No exchange; the
    shards walk in lockstep, one host read an iteration."""
    S = mesh.size

    def dist_u(s, u_ids):  # (B, K) u-indices -> distances
        return gather_score(g.upper_vecs[s], q_ext[s], bias[s],
                            u_ids.contiguous(), l2=l2)

    cur, cur_d, moved = [], [], []
    for s in range(S):
        B = q_ext[s].shape[0]
        c = torch.full((B,), g.entry_u, dtype=torch.int32, device=mesh.devices[s])
        cur.append(c)
        cur_d.append(dist_u(s, c[:, None])[:, 0])
    for level in range(g.top_level, 0, -1):
        moved = [torch.ones_like(c, dtype=torch.bool) for c in cur]
        while mesh.host_sum([m.any().to(torch.int32) for m in moved]) > 0:
            for s in range(S):
                cid, cdist = cur[s], cur_d[s]
                nbrs = g.upper_adj[s][cid.clamp_min(0).long(), level - 1]
                nbrs = torch.where(moved[s][:, None], nbrs, -1)
                d = dist_u(s, nbrs)
                j = torch.argmin(d, dim=1, keepdim=True)
                bd = torch.gather(d, 1, j)[:, 0]
                bi = torch.gather(nbrs, 1, j)[:, 0]
                # (dist, global id) lexicographic tie-break (heap.hh:53-57)
                ups = g.upper_ids[s]
                bg = torch.where(bi >= 0, ups[bi.clamp_min(0).long()], ID_MAX)
                cg = ups[cid.clamp_min(0).long()]
                better = ((bd < cdist) | ((bd == cdist) & (bg < cg))) & moved[s]
                cur[s] = torch.where(better, bi, cid)
                cur_d[s] = torch.where(better, bd, cdist)
                moved[s] = better
    return [g.upper_ids[s][cur[s].long()] for s in range(S)]


def _local_ids(ids: torch.Tensor, shard: int, rows_per_shard: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row of each id in shard ``shard``'s tables or -1, owned mask)."""
    local = ids - shard * rows_per_shard
    mine = (ids >= 0) & (local >= 0) & (local < rows_per_shard)
    return torch.where(mine, local, -1), mine


def _owned_neighbor_rows(g: ShardedGraph, shard: int, ids_all: torch.Tensor,
                         rows_per_shard: int) -> torch.Tensor:
    """The lists of the gathered frontier ids that ``shard`` owns, +1 (so
    that -1 pads survive the sum), zeros elsewhere."""
    local, mine = _local_ids(ids_all, shard, rows_per_shard)
    rows = g.neighbors0[shard][local.clamp_min(0).long()]
    return torch.where(mine[..., None], rows + 1, 0)


def _owned_distances(g: ShardedGraph, shard: int, q_ext_all, bias_all,
                     ids_all: torch.Tensor, rows_per_shard: int, l2: bool
                     ) -> torch.Tensor:
    """Distances of the candidate ids ``shard`` owns, 0 elsewhere. Row b of
    ``ids_all`` belongs to query b of the replicated batch, so the owner
    needs no routing information."""
    local, mine = _local_ids(ids_all, shard, rows_per_shard)
    d = gather_score(g.vectors[shard], q_ext_all, bias_all, local.contiguous(),
                     l2=l2)
    return torch.where(mine, d, 0.0)


def _owner_rpc(mesh: ShardMesh, ids_flat: list, aux_flat: list, payload_fn, *,
               rows_per_shard: int, bucket: int, width: int,
               dtype: torch.dtype, fill) -> tuple[list, int, list]:
    """The compact owner-computed exchange over bucketed ``all_to_all``.

    Each live id (>= 0) travels once to its owner, which computes a
    (width,) payload that travels once back; ids a shard owns itself never
    leave it. A (source, owner) pair carries at most ``bucket`` lanes a
    round; the rest wait for the next round, so nothing is dropped and the
    answer is the dense exchange's. ``payload_fn(shard, ids (S, bucket),
    aux (S, bucket)) -> (S, bucket, width)``: row i of the inputs holds the
    requests of source shard i, -1 where none.

    Returns (out per shard (L, width), rounds, off-diagonal granted lanes
    per shard as a device scalar).
    """
    S = mesh.size
    SCb = S * bucket
    pending = [ids.to(torch.int32) for ids in ids_flat]
    out = [torch.full((ids.shape[0], width), fill, dtype=dtype,
                      device=ids.device) for ids in ids_flat]
    lanes = [torch.zeros((), dtype=torch.int64, device=ids.device)
             for ids in ids_flat]
    rounds = 0
    while mesh.host_sum([(p >= 0).any().to(torch.int32) for p in pending]) > 0:
        send_ids, send_aux, slots, granted = [], [], [], []
        for s in range(S):
            p = pending[s]
            dev = p.device
            live = p >= 0
            owner = torch.where(live, torch.div(p, rows_per_shard,
                                                rounding_mode="floor"), 0).long()
            # each lane's rank among the lanes to its owner: a scan along
            # the lanes of an (S, L) one-hot (the last dim: a scan along
            # the first would run one thread a column)
            onehot = (owner[None, :] == torch.arange(S, device=dev)[:, None]) \
                & live[None, :]
            rank = torch.cumsum(onehot.to(torch.int32), dim=1) - 1
            rank = torch.gather(rank, 0, owner[None, :])[0]
            ok = live & (rank < bucket)
            slot = torch.where(ok, owner * bucket + rank, SCb)  # SCb = spare
            sid = torch.full((SCb + 1,), -1, dtype=torch.int32, device=dev)
            sid[slot] = torch.where(ok, p, -1)
            sax = torch.zeros((SCb + 1,), dtype=torch.int32, device=dev)
            sax[slot] = torch.where(ok, aux_flat[s], 0)
            send_ids.append(sid[:SCb].reshape(S, bucket))
            send_aux.append(sax[:SCb].reshape(S, bucket))
            slots.append(slot)
            granted.append(ok)
            lanes[s] = lanes[s] + (ok & (owner != s)).sum()
        recv_ids = mesh.all_to_all(send_ids)
        recv_aux = mesh.all_to_all(send_aux)
        back = mesh.all_to_all([payload_fn(s, recv_ids[s], recv_aux[s])
                                for s in range(S)])
        for s in range(S):
            got = back[s].reshape(SCb, width)[slots[s].clamp_max(SCb - 1)]
            out[s] = torch.where(granted[s][:, None], got, out[s])
            pending[s] = torch.where(granted[s], -1, pending[s])
        rounds += 1
    return out, rounds, lanes


def _rpc_bucket(lanes: int, num_shards: int, slack: float) -> int:
    """Fixed per-(source, owner) bucket: the uniform load (lanes / S) times
    ``slack``, at least 8, rounded up to a multiple of 8."""
    want = int(lanes * slack / num_shards)
    return max(8, -(-want // 8) * 8)


@dataclasses.dataclass
class ShardedResult:
    """One batch's outputs, per shard where a list."""

    ids: list[torch.Tensor]  # (B_loc, k) int32
    dists: list[torch.Tensor]  # (B_loc, k) f32
    hops: list[torch.Tensor]  # (B_loc,) int32 expansions
    cache_hits: list[torch.Tensor]  # (B_loc,) int32
    cache_misses: list[torch.Tensor]  # (B_loc,) int32
    row_counts: list[torch.Tensor]  # (rows,) owned-row accesses, or empty
    hot_counts: torch.Tensor  # (H,) replica-hit accesses summed, or empty
    rpc_rounds: int  # compact-exchange rounds (0 on the dense exchange)
    ici_lanes: int  # off-diagonal lanes the compact exchange shipped
    ici_bytes: float  # wire bytes of all shards, an f32 sum as in JAX
    steps: int  # layer-0 steps


def _sharded_search(
    mesh: ShardMesh,
    g: ShardedGraph,
    q_ext: list[torch.Tensor],  # (B_loc, d) per shard
    bias: list[torch.Tensor],  # (B_loc,) per shard
    replica: list[HotReplica] | None,
    *,
    sp: SearchParams,  # resolved
    metric: int,
    count_access: bool = False,
) -> ShardedResult:
    """The SPMD body, every shard over its query slice, in lockstep.

    With a replica, the frontier lists and candidate distances of its ids
    are served on the asking shard: those lanes are masked out of the
    owners' work and filled in after the exchange (the reference's
    cache_lookup short-circuit, hnsw.hh:524-548).
    """
    S = mesh.size
    rps = g.rows_per_shard
    B_loc = q_ext[0].shape[0]
    compact = sp.exchange == "compact"
    l2 = metric == METRIC_L2
    E = sp.frontier
    W = g.neighbors0[0].shape[1]
    K = E * W
    f32 = np.float32
    # replicate the query batch once; the exchanges then carry ids and
    # distances only
    q_ext_all = mesh.all_gather(q_ext)
    bias_all = mesh.all_gather(bias)

    beams = []
    if sp.entry_mode == "dense":
        # seeds from the replicated upper vertices: no exchange. The sweep
        # picks them; K1 rescores them, one sum order per pair
        m = min(sp.entry_seeds, g.upper_ids[0].shape[0])
        for s in range(S):
            _, pos = dense_entry_positions(q_ext[s], bias[s], g.upper_vecs[s],
                                           m, l2)
            seed_d = gather_score(g.upper_vecs[s], q_ext[s], bias[s],
                                  pos.to(torch.int32), l2=l2)
            beams.append(beam_merge(beam_init(B_loc, sp.ef, mesh.devices[s]),
                                    seed_d, g.upper_ids[s][pos]))
    else:
        ep = _upper_descent(mesh, g, q_ext, bias, l2)
        # the entry distance through the owner-computed exchange
        ep_all = mesh.all_gather([e[:, None] for e in ep])
        ep_d = mesh.psum_scatter([
            _owned_distances(g, s, q_ext_all[s], bias_all[s], ep_all[s], rps, l2)
            for s in range(S)])
        for s in range(S):
            beams.append(beam_merge(beam_init(B_loc, sp.ef, mesh.devices[s]),
                                    ep_d[s], ep[s][:, None]))

    def zeros(n, dtype, s):
        return torch.zeros(n, dtype=dtype, device=mesh.devices[s])

    hops = [zeros(B_loc, torch.int32, s) for s in range(S)]
    hits_acc = [zeros(B_loc, torch.int32, s) for s in range(S)]
    miss_acc = [zeros(B_loc, torch.int32, s) for s in range(S)]
    # the access counts keep a spare last slot for the lanes that count
    # nothing (JAX's mode="drop"), so that no count reads a length back
    row_counts = [zeros((rps if count_access else 0) + 1, torch.float32, s)
                  for s in range(S)]
    H = replica[0].capacity if (count_access and replica is not None) else 0
    hot_counts = [zeros(H + 1, torch.float32, s) for s in range(S)]
    lanes_acc = [zeros((), torch.int64, s) for s in range(S)]
    rpc_rounds = 0
    ici_bytes = f32(0)  # one shard's f32 accumulator (all shards agree)
    # the compact distance exchange's aux: each lane's index in its shard's
    # (B_loc, K) candidate table (the JAX package sends the query slot alone;
    # both are one int32 a lane)
    lane_ids = [torch.arange(B_loc * K, dtype=torch.int32, device=d)
                for d in mesh.devices]

    step = 0
    while step < sp.max_steps:
        done = mesh.host_sum([b.expanded.all().to(torch.int32) for b in beams])
        if done >= S:
            break
        actives, f_rows, f_hit, fids_cold = [], [], [], []
        for s in range(S):
            slots, fid, active = beam_frontier_multi(beams[s], E)
            beams[s] = beam_mark_expanded(beams[s], slots, active)
            actives.append(active)
            if replica is not None:
                r, h = replica_lookup(replica[s], fid)
                f_rows.append(r)
                f_hit.append(h)
                fids_cold.append(torch.where(h, -1, fid))
            else:
                fids_cold.append(fid)
        step_bytes = f32(0)

        # exchange 1: the frontier lists from their owners
        if compact:
            def nbr_payload(s, recv_ids, _aux):
                local, _ = _local_ids(recv_ids, s, rps)
                rows = g.neighbors0[s][local.clamp_min(0).long()]
                return torch.where(recv_ids[..., None] >= 0, rows, -1)

            bucket_f = _rpc_bucket(B_loc * E, S, sp.exchange_slack)
            rows, r1, l1 = _owner_rpc(
                mesh, [f.reshape(-1) for f in fids_cold],
                [zeros(B_loc * E, torch.int32, s) for s in range(S)],
                nbr_payload, rows_per_shard=rps, bucket=bucket_f, width=W,
                dtype=torch.int32, fill=-1)
            nbrs = [r.reshape(B_loc, K) for r in rows]
            rpc_rounds += r1
            lanes_acc = [a + b for a, b in zip(lanes_acc, l1)]
            # off-diagonal payload a round: ids + aux out, W list entries back
            step_bytes = step_bytes + f32(r1) * f32((S - 1) * bucket_f * (8 + 4 * W))
        else:
            fid_all = mesh.all_gather(fids_cold)
            nbrs = mesh.psum_scatter([
                _owned_neighbor_rows(g, s, fid_all[s], rps).reshape(S * B_loc, K)
                for s in range(S)])
            nbrs = [n - 1 for n in nbrs]  # undo the +1: 0 -> -1 (pad, inactive)
            # all_gather receives (S-1) peer slices; the reduce-scatter ships
            # about the whole (S * B_loc, E * W) once a shard
            step_bytes = step_bytes + f32((S - 1) * B_loc * E * 4
                                          + (S - 1) * B_loc * E * W * 4)
        cands, c_rows, c_hit, cand_cold = [], [], [], []
        for s in range(S):
            cand = nbrs[s]
            if replica is not None:
                local = replica[s].hot_neighbors[f_rows[s]]  # (B_loc, E, W)
                cand = torch.where(
                    f_hit[s][:, :, None],
                    torch.where(actives[s][:, :, None], local, -1),
                    cand.reshape(B_loc, E, W),
                ).reshape(B_loc, K)
                r, h = replica_lookup(replica[s], cand)
                c_rows.append(r)
                c_hit.append(h)
                cand_cold.append(torch.where(h, -1, cand).contiguous())
            else:
                cand_cold.append(cand.contiguous())
            cands.append(cand)

        # exchange 2: the cold candidates' distances, scored by their owners
        cand_all = None
        if compact:
            def dist_payload(s, recv_ids, recv_aux):
                # the received lanes go back to their (query, lane) cells of
                # one (S * B_loc, K) call, the dense exchange's shape, with a
                # spare column for the empty slots
                local, _ = _local_ids(recv_ids, s, rps)
                src = torch.arange(S, dtype=torch.int64,
                                   device=recv_ids.device)[:, None]
                live = recv_ids >= 0
                row = (src * B_loc + torch.div(recv_aux, K, rounding_mode="floor")
                       ).reshape(-1)
                col = torch.where(live, recv_aux % K, K).reshape(-1).long()
                ids = torch.full((S * B_loc, K + 1), -1, dtype=torch.int32,
                                 device=recv_ids.device)
                ids[row, col] = local.reshape(-1)
                d = gather_score(g.vectors[s], q_ext_all[s], bias_all[s], ids, l2=l2)
                return d[row, col].reshape(S, -1, 1)

            bucket_c = _rpc_bucket(B_loc * K, S, sp.exchange_slack)
            d_rpc, r2, lanes2 = _owner_rpc(
                mesh, [c.reshape(-1) for c in cand_cold], lane_ids, dist_payload,
                rows_per_shard=rps, bucket=bucket_c, width=1,
                dtype=torch.float32, fill=torch.inf)
            dist = [d.reshape(B_loc, K) for d in d_rpc]
            rpc_rounds += r2
            lanes_acc = [a + b for a, b in zip(lanes_acc, lanes2)]
            # ids + lane aux out, one f32 distance back
            step_bytes = step_bytes + f32(r2) * f32((S - 1) * bucket_c * 12)
            if count_access:
                # a gather for the access counters alone: real traffic,
                # counted so that compact and dense compare honestly
                cand_all = mesh.all_gather(cand_cold)
                step_bytes = step_bytes + f32((S - 1) * B_loc * K * 4)
        else:
            cand_all = mesh.all_gather(cand_cold)
            dist = mesh.psum_scatter([
                _owned_distances(g, s, q_ext_all[s], bias_all[s], cand_all[s],
                                 rps, l2) for s in range(S)])
            step_bytes = step_bytes + f32(2 * (S - 1) * B_loc * K * 4)

        for s in range(S):
            d = torch.where(cand_cold[s] >= 0, dist[s], torch.inf)
            hit_ok = None
            if replica is not None:
                hit_ok = c_hit[s] & (cands[s] >= 0)
                d_local = gather_score(
                    replica[s].hot_vecs, q_ext[s], bias[s],
                    torch.where(hit_ok, c_rows[s], -1).to(torch.int32).contiguous(),
                    l2=l2)
                d = torch.where(c_hit[s], d_local, d)
                hits_acc[s] += hit_ok.sum(dim=1, dtype=torch.int32)
            beams[s] = beam_merge(beams[s], d, cands[s])
            miss_acc[s] += (cand_cold[s] >= 0).sum(dim=1, dtype=torch.int32)
            hops[s] += actives[s].sum(dim=1, dtype=torch.int32)
            if count_access:
                # the owners count accesses to their rows; the host refreshes
                # the hot set between batches (the reference admits during
                # queries, hnsw.hh:446-453)
                local, _ = _local_ids(cand_all[s], s, rps)
                idx = torch.where(local >= 0, local, rps).reshape(-1).long()
                row_counts[s].index_add_(0, idx, torch.ones(
                    idx.shape, dtype=torch.float32, device=idx.device))
                if replica is not None:
                    hidx = torch.where(hit_ok, c_rows[s], H).reshape(-1)
                    hot_counts[s].index_add_(0, hidx, torch.ones(
                        hidx.shape, dtype=torch.float32, device=hidx.device))
        ici_bytes = ici_bytes + step_bytes
        step += 1

    total_bytes = f32(0)
    for _ in range(S):  # the psum of the shards' equal f32 accumulators
        total_bytes = total_bytes + ici_bytes
    return ShardedResult(
        ids=[b.ids[:, : sp.k] for b in beams],
        dists=[b.dists[:, : sp.k] for b in beams],
        hops=hops,
        cache_hits=hits_acc,
        cache_misses=miss_acc,
        row_counts=[c[:-1] for c in row_counts],
        hot_counts=mesh.psum([c[:-1] for c in hot_counts])[0],
        rpc_rounds=rpc_rounds,
        ici_lanes=mesh.host_sum(lanes_acc),
        ici_bytes=float(total_bytes),
        steps=step,
    )


def make_sharded_search(mesh: ShardMesh, sp: SearchParams, metric: int):
    """The search of one batch on ``mesh``: ``run(g, queries (B, d),
    replica=None, count_access=False) -> ShardedResult``, B a multiple of
    the shard count. The batch's extended queries are computed once on the
    first shard's device and scattered, so that every shard count sees the
    same bits."""
    sp = sp.resolved()

    def run(g: ShardedGraph, queries: torch.Tensor,
            replica: list[HotReplica] | None = None, *,
            count_access: bool = False) -> ShardedResult:
        q = queries.to(device=mesh.devices[0], dtype=torch.float32)
        q_ext, bias = _extend_query(q, metric)
        return _sharded_search(mesh, g, mesh.scatter(q_ext), mesh.scatter(bias),
                               replica, sp=sp, metric=metric,
                               count_access=count_access)

    return run


class SlackController:
    """A measured-bytes probe over the compact exchange's bucket slack.

    The best slack depends on skew, routing and the replica's hit rate.
    The ladder serves one live batch at each level (results are the same
    at any slack: overflow waits for the next round), then serves at the
    level with the fewest measured wire bytes a batch, and probes again
    every ``reprobe_every`` batches (the reference sizes doorbell batches
    to the work requests, rdma-library/library/batched_read.hh:28-60).
    """

    LADDER = (1.0, 1.5, 2.0)

    def __init__(self, reprobe_every: int = 64):
        self.reprobe_every = reprobe_every
        self.samples: dict = {}
        self.batches = 0

    def pick(self) -> float:
        self.batches += 1
        if self.batches % self.reprobe_every == 0:
            self.samples = {}
        for lv in self.LADDER:
            if lv not in self.samples:
                return lv
        return min(self.samples, key=self.samples.get)

    def observe(self, level: float, nbytes: float) -> None:
        if level not in self.samples:
            self.samples[level] = nbytes


class ShardedIndex:
    """The graph sharded over a mesh, with the sharded search: the stand-in
    for the reference's compute and memory nodes (the mesh plays the
    cluster, shards the memory nodes, query slices the compute nodes).

    ``cache_capacity`` > 0 replicates that many hot vertices on every shard
    (``adaptive_cache`` re-ranks them from access counts every
    ``refresh_every`` batches); ``routing`` True or "static" orders each
    batch so that slice s holds the queries nearest shard s's region,
    "adaptive" also carries the slices' load from batch to batch. Neither
    changes a result. Counters: ``cache_hits``, ``cache_misses``,
    ``rpc_rounds``, ``ici_lanes``, ``ici_bytes`` (all searches), and
    ``last_hops``, ``last_steps`` (the last search), ``readbacks`` and
    ``batches`` (host reads of lockstep flags, and batches served).
    """

    def __init__(self, graph, mesh: ShardMesh, *, cache_capacity: int = 0,
                 routing: bool | str = False, adaptive_cache: bool = False,
                 refresh_every: int = 8, rows: str = "f32"):
        self.graph = graph
        self.mesh = mesh
        self.rows = rows
        self.device = shard_graph(graph, mesh, rows=rows)
        self.metric = graph.params.metric_id
        self.replica: list[HotReplica] | None = None
        self.access = None
        self.refresh_every = refresh_every
        self.refreshes = 0
        self._batches_seen = 0
        if cache_capacity:
            self.cache_capacity = min(cache_capacity, graph.n)
            self._put_replica(select_hot_ids(graph, cache_capacity))
            if adaptive_cache:
                # the cooling table's stand-in (cache.hh:232-311): decayed
                # access counts, the hot set re-ranked on the host
                self.access = AccessCounter(graph.n)
        self.routing_mode = routing if isinstance(routing, str) else (
            "static" if routing else None)
        if self.routing_mode:
            self._placement = Placement(graph, mesh.size)
            self._adaptive_router = None
        self.cache_hits = 0
        self.cache_misses = 0
        self.rpc_rounds = 0
        self.ici_lanes = 0
        self.ici_bytes = 0.0
        self.last_hops = 0
        self.last_steps = 0
        self.readbacks = 0
        self.batches = 0
        self._slack_ctl: SlackController | None = None

    def _put_replica(self, hot_ids: np.ndarray) -> None:
        rep = build_replica(self.graph, hot_ids, rows=self.rows, device="cpu")
        self.replica = replicate_replica(rep, self.mesh.devices)

    def _absorb_counts(self, res: ShardedResult) -> None:
        """Fold one batch's access counts into the decayed host counter and
        refresh the replica when due. A refresh swaps the replica's
        contents only: hits serve the rows the owners would, so results do
        not change."""
        row_counts = torch.cat([c.cpu() for c in res.row_counts]).numpy()
        self.access.absorb(row_counts, self.replica[0].hot_ids.cpu().numpy(),
                           res.hot_counts.cpu().numpy())
        self._batches_seen += 1
        if self._batches_seen % self.refresh_every == 0:
            self.refresh_cache()

    def refresh_cache(self) -> None:
        """Re-rank the hot set from the decayed counts and swap the replica
        (the reference's post-warmup steady state, compute_node.cc:116-131)."""
        if self.access is None:
            return
        self._put_replica(select_hot_ids(self.graph, self.cache_capacity,
                                         self.access.counts))
        self.refreshes += 1

    def warm(self, queries: np.ndarray, search_params=None, *,
             batch_size: int = 4096) -> None:
        """A warm-up pass that heats the access counters, then a refresh, so
        that the timed run starts with an adapted hot set; the hit counters
        reset afterwards (compute_node.cc:116-131)."""
        self.search(queries, search_params, batch_size=batch_size)
        self.refresh_cache()
        self.cache_hits = 0
        self.cache_misses = 0

    def _run_batch(self, sp: SearchParams, chunk: np.ndarray):
        """One batch on the mesh; folds the counters and the adaptation
        loop. Returns (ids, dists, hops) as numpy."""
        reads0 = self.mesh.readbacks
        run = make_sharded_search(self.mesh, sp, self.metric)
        res = run(self.device, torch.from_numpy(chunk), self.replica,
                  count_access=self.access is not None)
        if self.replica is not None:
            self.cache_hits += sum(int(h.sum()) for h in res.cache_hits)
            self.cache_misses += sum(int(m.sum()) for m in res.cache_misses)
            if self.access is not None:
                self._absorb_counts(res)
        self.rpc_rounds += res.rpc_rounds
        self.ici_lanes += res.ici_lanes
        self.ici_bytes += res.ici_bytes
        hops = torch.cat([h.cpu() for h in res.hops]).numpy()
        self.last_hops += int(hops.sum())
        self.last_steps += res.steps
        self.readbacks += self.mesh.readbacks - reads0
        self.batches += 1
        ids = torch.cat([i.cpu() for i in res.ids]).numpy()
        dd = torch.cat([d.cpu() for d in res.dists]).numpy()
        return ids, dd, hops

    def _dispatch_batch(self, sp: SearchParams, chunk: np.ndarray):
        """One batch; under the slack ladder, at the level the controller
        picks, with the measured wire bytes fed back."""
        if not (sp.exchange == "compact" and sp.adaptive_slack):
            return self._run_batch(sp, chunk)
        lv = self._slack_ctl.pick()
        b0 = self.ici_bytes
        out = self._run_batch(dataclasses.replace(sp, exchange_slack=lv), chunk)
        self._slack_ctl.observe(lv, self.ici_bytes - b0)
        return out

    def search(self, queries: np.ndarray,
               search_params: SearchParams | None = None, *,
               batch_size: int = 4096) -> tuple[np.ndarray, np.ndarray]:
        """Search any number of queries in batches of ``batch_size``
        (rounded up to a multiple of the shard count), the tail padded with
        zero queries."""
        sp = (search_params or SearchParams()).resolved()
        S = self.mesh.size
        batch_size = -(-batch_size // S) * S
        nq, d = queries.shape
        self.last_hops = 0
        self.last_steps = 0
        if sp.exchange == "compact" and sp.adaptive_slack and self._slack_ctl is None:
            self._slack_ctl = SlackController()
        if self.routing_mode == "adaptive":
            return self._search_adaptive(queries, sp, batch_size)
        perm = None
        if self.routing_mode == "static":
            router = QueryRouter(self._placement, batch_size=batch_size)
            perm, _ = router.plan(queries)
            queries, _ = router.apply(queries, perm)
        nq_eff = len(queries)
        out_i = np.empty((nq_eff, sp.k), dtype=np.int32)
        out_d = np.empty((nq_eff, sp.k), dtype=np.float32)
        for lo in range(0, nq_eff, batch_size):
            hi = min(lo + batch_size, nq_eff)
            chunk = np.zeros((batch_size, d), dtype=np.float32)
            chunk[: hi - lo] = queries[lo:hi]
            ids, dd, _ = self._dispatch_batch(sp, chunk)
            out_i[lo:hi] = ids[: hi - lo]
            out_d[lo:hi] = dd[: hi - lo]
        if perm is not None:
            out_i = QueryRouter.unpermute(out_i, perm, nq)
            out_d = QueryRouter.unpermute(out_d, perm, nq)
        return out_i, out_d

    def _search_adaptive(self, queries, sp, batch_size):
        """Batch at a time with cross-batch quota feedback
        (query_router.hh:106-151,315-316): each served batch's per-slice
        hops set the next batch's quotas."""
        nq = queries.shape[0]
        ar = self._adaptive_router
        if ar is None or ar.batch_size != batch_size:
            ar = AdaptiveQueryRouter(self._placement, batch_size=batch_size)
            self._adaptive_router = ar
        ar.start(queries)
        perm_parts, id_parts, d_parts = [], [], []
        while (pb := ar.next_batch()) is not None:
            routed, valid = QueryRouter.apply(queries, pb)
            ids, dd, hops = self._dispatch_batch(sp, routed.astype(np.float32))
            ar.observe(np.where(valid, hops, 0))
            perm_parts.append(pb)
            id_parts.append(ids)
            d_parts.append(dd)
        perm = np.concatenate(perm_parts)
        out_i = QueryRouter.unpermute(np.concatenate(id_parts), perm, nq)
        out_d = QueryRouter.unpermute(np.concatenate(d_parts), perm, nq)
        return out_i, out_d
