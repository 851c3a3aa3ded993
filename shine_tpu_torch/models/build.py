"""On-device batched HNSW construction: the port of
``shine_tpu/models/build.py``.

The reference inserts under per-vertex remote spinlocks
(``src/hnsw/hnsw.hh:40-251``). The JAX package redesigns
that as batched insert rounds, and so does the port: round r inserts a
batch of B nodes against the graph of every earlier round, and within a
round the B nodes do not see each other. A round is a read-only plan and a
deterministic apply:

  plan (``plan_round``): each node descends greedily from the entry point
  to the level above its own (``_greedy_to_level``), runs an
  ef_construction beam search on each of its levels (``_search_level``)
  and selects M neighbours there with the diversity heuristic
  (``select_heuristic``);
  apply (``apply_round``): each node writes its own lists, then the
  reverse-edge requests (neighbour -> new node) are sorted by (vertex, new
  id) and appended in that order where a list has room
  (``_apply_reverse_edges``); a list that overflows is re-pruned with the
  heuristic over its entries and the rejected requests
  (``_shrink_overflow``).

Levels are drawn for the whole set up front (``draw_levels``, numpy, bit
for bit with the JAX package), so upper rows are assigned by a prefix sum.

On a card every search of a round, on layer 0 and on the upper levels, is
the gated loop of the fused beam-step kernel (``ops/beam_step.py``, driven
by ``models/hnsw.py:run_beam_steps``, ``term="ef"``); the greedy descent
and the re-prune score through ``ops/gather_score.py``. On the CPU both
wrappers run their plain twins. The select and the apply are plain torch.
A plan reads only ids below ``count`` and an apply writes only ids below
the new count, so no list ever holds an id at or past ``count`` when a
round plans: the JAX package's ``nbrs < count`` mask has nothing to drop
and the port does not apply it.

``draw_levels`` is numpy; ``select_heuristic`` is torch on the device of
its inputs; its pairwise tile is a full-fp32 product (``check_precision``),
so on the same f32 inputs it keeps what the JAX package keeps wherever the
two products agree (always on integer-valued rows). The distances differ
from the JAX package's by ulps on Gaussian rows (the port sums ``bias +
(q_ext . v + |v|^2)``, the JAX package ``(|q|^2 - 2 q . v) + |v|^2``), and
are equal on integer-valued rows, where a build equals the JAX build bit
for bit. The sharded round (``make_sharded_insert_round``, ``mesh=``) is
not ported (ROADMAP A8c).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, HNSWParams, SearchParams
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.graph.soa import GraphSoA
from shine_tpu_torch.models.hnsw import _l0_state, run_beam_steps
from shine_tpu_torch.ops.beam import Beam, dist_id_key
from shine_tpu_torch.ops.distance import check_precision
from shine_tpu_torch.ops.gather_score import gather_score

INT32_MAX = 2**31 - 1
LEVEL_CAP = 12  # the highest level a node is drawn at
# the seconds a ``timings`` dict collects, one key a stage of a round
STAGES = ("descent", "upper_search", "l0_search", "select", "own_rows",
          "reverse_edges", "reprune")


def draw_levels(n: int, params: HNSWParams) -> np.ndarray:
    """Geometric level draw, floor(-log(U) * m_L) (the reference's
    hnsw.hh:48), from numpy's generator seeded with ``params.seed``."""
    rng = np.random.default_rng(params.seed)
    u = rng.random(n)
    return np.floor(-np.log(u) * params.m_L).astype(np.int32)


def select_heuristic(
    cand_ids: torch.Tensor,  # (B, C) sorted by (dist, id) ascending, -1 pad
    cand_dists: torch.Tensor,  # (B, C)
    cand_vecs: torch.Tensor,  # (B, C, d)
    cand_sqnorms: torch.Tensor,  # (B, C)
    M: int,
    metric: int,
    fill: bool = False,
    with_dists: bool = False,
):
    """Diversity selection (the reference's select_heuristic, hnsw.hh:482-522):
    scan the candidates nearest first and keep c iff dist(c, q) <
    dist(c, s) for every kept s, at most M. One (C, C) pairwise tile a row
    feeds the scan, which runs as a fixed-point iteration over whole tiles
    (a few dozen tile steps in place of C column steps) and ends on the
    sequential scan's set exactly.

    ``fill`` tops unfilled slots up with the nearest pruned candidates
    (hnswlib's keepPrunedConnections), as the scan-speed build needs: its
    pools are nearest-only, which the bare heuristic over-prunes.

    Returns (sel_ids (B, M) int32, -1 padded, sel_count (B,) int32); with
    ``with_dists`` also the kept candidates' query distances (B, M), inf
    padded. The kept ids are compacted into M + 1 columns whose last one
    takes every dropped candidate and is cut off: it is never a slot."""
    check_precision()
    B, C = cand_ids.shape
    dev = cand_ids.device
    v = cand_vecs.to(torch.float32)
    # the pair tile is built in place in the product's buffer, the same
    # bits as |c|^2 - 2 c.e + |e|^2 (or 1 - c.e), and freed before the
    # fixed point: the (C, C) tiles alive at once take 5 bytes a cell
    pair = torch.bmm(v, v.transpose(1, 2))
    if metric == METRIC_L2:
        sq = cand_sqnorms.to(torch.float32)
        pair.mul_(-2.0).add_(sq[:, :, None]).add_(sq[:, None, :])
    else:
        pair.neg_().add_(1.0)
    dists = cand_dists.to(torch.float32)
    valid = cand_ids >= 0
    # blocks[b, c, e]: candidate e, nearer the query than c (e < c), lies
    # closer to c than the query does
    blocks = pair < dists[:, :, None]
    del pair
    blocks &= torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
    # the scan keeps c iff it is valid, no kept e < c blocks it and fewer
    # than M are kept before it: kept = F(kept), where F(K)[c] reads only
    # K[:c]. Iterating F from any start makes one more leading column right
    # each time, so it reaches the scan's set within C steps and stays
    kept = valid
    for _ in range(C + 1):
        before = torch.cumsum(kept, dim=1, dtype=torch.int32) - kept.to(torch.int32)
        new = valid & ~(blocks & kept[:, None, :]).any(dim=2) & (before < M)
        if torch.equal(new, kept):
            break
        kept = new
    n_kept = kept.sum(dim=1, dtype=torch.int32)
    if fill:
        pruned = ~kept & valid
        prank = torch.cumsum(pruned.to(torch.int32), dim=1) - 1
        take = pruned & (prank < (M - n_kept)[:, None])
        kept = kept | take
        n_kept += take.sum(dim=1, dtype=torch.int32)
    slot = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    slot = torch.where(kept, slot, M)  # dropped: the throwaway column M
    sel = torch.full((B, M + 1), -1, dtype=torch.int32, device=dev)
    sel.scatter_(1, slot, cand_ids.to(torch.int32))
    if with_dists:
        sd = torch.full((B, M + 1), torch.inf, dtype=torch.float32, device=dev)
        sd.scatter_(1, slot, dists)
        return sel[:, :M], n_kept, sd[:, :M]
    return sel[:, :M], n_kept


@dataclasses.dataclass
class BuildState:
    """Construction state of capacity N on one device.

    The adjacency tables carry one spare row past their last real one (row
    N of ``neighbors0`` and ``degree0``, row U of ``upper_neighbors`` and
    ``upper_degree``). Every write that the JAX package drops
    (``mode="drop"``) lands there instead, so no scatter waits for the host
    to compact its indices; the spare row holds whatever was written last
    and nothing reads it. The scalars live on the host: the loops that
    read them run there."""

    vectors: torch.Tensor  # (N, d) f32
    vec_sqnorms: torch.Tensor  # (N,) f32, numpy-summed; zeros off L2
    levels: torch.Tensor  # (N,) int32, drawn up front
    upper_row: torch.Tensor  # (N,) int32, prefix-sum assigned, -1 on level 0
    neighbors0: torch.Tensor  # (N + 1, 2M) int32, -1 pad
    degree0: torch.Tensor  # (N + 1,) int32
    upper_neighbors: torch.Tensor  # (U + 1, L, M) int32, -1 pad
    upper_degree: torch.Tensor  # (U + 1, L) int32
    entry_point: int
    entry_level: int
    count: int  # nodes inserted so far

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def n(self) -> int:
        return self.vectors.shape[0]


def init_build_state(
    vectors: np.ndarray, params: HNSWParams, *, level_cap: int = LEVEL_CAP,
    device: torch.device | str | None = None,
) -> BuildState:
    """The state before the first round, on ``device`` (the CUDA card unless
    another is given): the level draw, the upper rows and the capacities
    computed in numpy as the JAX package does; node 0 bootstraps the index
    (hnsw.hh:56-84)."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n = vectors.shape[0]
    levels = np.minimum(draw_levels(n, params), level_cap).astype(np.int32)
    upper_row = np.where(levels > 0, np.cumsum(levels > 0) - 1, -1).astype(np.int32)
    u_cap = max(int(upper_row.max()) + 1, 1)
    L = max(int(levels.max()), 1)
    M, M0 = params.M_max, params.M_max0
    sq = (vectors.astype(np.float32) ** 2).sum(axis=1).astype(np.float32)
    if params.metric_id != METRIC_L2:
        sq = np.zeros_like(sq)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev, copy=True)

    def fill(shape, value: int) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return BuildState(
        vectors=put(vectors),
        vec_sqnorms=put(sq),
        levels=put(levels),
        upper_row=put(upper_row),
        neighbors0=fill((n + 1, M0), -1),
        degree0=fill((n + 1,), 0),
        upper_neighbors=fill((u_cap + 1, L, M), -1),
        upper_degree=fill((u_cap + 1, L), 0),
        entry_point=0,
        entry_level=int(levels[0]),
        count=1,
    )


@contextlib.contextmanager
def _timed(timings: dict | None, stage: str, dev: torch.device):
    """Add the stage's seconds to ``timings[stage]``, the card synchronised
    on both ends; nothing without a dict."""
    if timings is None:
        yield
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# distances and lists on the evolving graph


def _pads(rows: int, width: int, dev: torch.device) -> torch.Tensor:
    """A (rows, width) block of -1 list pads."""
    return torch.full((rows, width), -1, dtype=torch.int32, device=dev)


def _query_ext(st: BuildState, ids: torch.Tensor, l2: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_ext (B, d), bias (B,)) of the rows ``ids`` (int64, >= 0), so that
    dist = bias + q_ext . v [+ |v|^2]: under L2 the stored squared norm is
    the bias, as it is the JAX package's |q|^2."""
    q = st.vectors[ids]
    if l2:
        return (-2.0 * q).contiguous(), st.vec_sqnorms[ids].contiguous()
    return (-q).contiguous(), torch.ones(q.shape[0], dtype=torch.float32,
                                         device=q.device)


def _dists(st: BuildState, q_ext: torch.Tensor, bias: torch.Tensor,
           ids: torch.Tensor, l2: bool) -> torch.Tensor:
    """(B, K) distances from each query to the candidate rows ``ids``
    (int32), inf where id < 0: the kernel on a card, its twin on the CPU."""
    return gather_score(st.vectors, q_ext, bias, ids.contiguous(), l2=l2)


def _neighbors_at(st: BuildState, ids: torch.Tensor, level_minus1: int
                  ) -> torch.Tensor:
    """Lists (B, M) of ``ids`` (B,) at upper level ``level_minus1 + 1``,
    -1 where an id is -1 or has no upper row."""
    rows = st.upper_row[ids.clamp_min(0).long()]
    nb = st.upper_neighbors[rows.clamp_min(0).long(), level_minus1]
    ok = (ids >= 0) & (rows >= 0)
    return torch.where(ok[:, None], nb, -1)


def _level_lists(st: BuildState, level: int) -> torch.Tensor:
    """The (N, W) lists of every id on ``level``: ``neighbors0`` on layer 0,
    else each id's upper list there (-1 where it has none), W = M."""
    if level == 0:
        return st.neighbors0[: st.n]
    every = torch.arange(st.n, dtype=torch.int32, device=st.device)
    return _neighbors_at(st, every, level - 1).contiguous()


# ---------------------------------------------------------------------------
# per-level beam search over the evolving graph (search_level semantics)


def _search_level(
    st: BuildState, q_ext: torch.Tensor, bias: torch.Tensor,
    ep_ids: torch.Tensor, ep_dists: torch.Tensor, level: int, ef: int,
    frontier: int, l2: bool,
) -> Beam:
    """Best-first beam of width ef on one level of the current graph,
    seeded with one entry a query (id -1: none); returns the beam. Steps
    run in lockstep until every entry of every beam is expanded or
    2 * ceil(ef / frontier) + 8 steps have run: the gated ``beam_step``
    loop (``term="ef"``) over the level's lists, ``neighbors0`` on layer 0
    and on an upper level an (N, M) table of every id's list there (-1
    where an id has none), the JAX package's ``get_nbrs``."""
    E = frontier
    sp = SearchParams(k=ef, ef=ef, frontier=E, max_steps=2 * ((ef + E - 1) // E) + 8,
                      term="ef")
    state = _l0_state(ep_ids[:, None].contiguous(), ep_dists[:, None].contiguous(), sp)
    run_beam_steps(st.vectors, _level_lists(st, level), q_ext, bias, state, sp,
                   l2=l2)
    return state[0]


def _greedy_to_level(
    st: BuildState, q_ext: torch.Tensor, bias: torch.Tensor,
    target_level: torch.Tensor, l2: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy descent from the entry point, each query down to its
    ``target_level`` + 1 (hnsw.hh:129-140); returns per query (ep_id,
    ep_dist). A step moves to the best listed neighbour by (dist, id): the
    first of the nearest in list order, if it beats the current one."""
    B = q_ext.shape[0]
    cur = torch.full((B,), st.entry_point, dtype=torch.int32, device=q_ext.device)
    cur_d = _dists(st, q_ext, bias, cur[:, None], l2)[:, 0]
    for lvl in range(st.entry_level, 0, -1):
        moved = lvl > target_level
        while bool(moved.any()):
            nbrs = torch.where(moved[:, None], _neighbors_at(st, cur, lvl - 1), -1)
            bd, j = _dists(st, q_ext, bias, nbrs, l2).min(dim=1)
            bi = torch.gather(nbrs, 1, j[:, None])[:, 0]
            moved = ((bd < cur_d) | ((bd == cur_d) & (bi < cur))) & moved
            cur = torch.where(moved, bi, cur)
            cur_d = torch.where(moved, bd, cur_d)
    return cur, cur_d


# ---------------------------------------------------------------------------
# reverse-edge application (replaces the spinlock and shrink, hnsw.hh:180-225)


def _apply_reverse_edges(
    nbr_table: torch.Tensor,  # (R + 1, cap) lists of one level, spare row R
    deg_table: torch.Tensor,  # (R + 1,)
    row_of,  # callable: global id -> row of nbr_table
    vertices: torch.Tensor,  # (E,) int32 vertices receiving an edge, -1 none
    new_ids: torch.Tensor,  # (E,) int32 the new nodes linked back
):
    """Append reverse edges where there is room, in place, deterministically.

    The requests are sorted by (vertex, new id), the -1 pads first (one
    stable sort of an int64 key, ``jnp.lexsort``'s order); a request's slot
    is its vertex's degree plus its rank among the vertex's requests, and
    the requests whose slot fits scatter in ((row, slot) pairs are
    distinct; the rest go to the spare row). Returns (sorted vertices,
    sorted new ids, accepted (E,) bool, overflow vertices (E,): one entry
    per vertex whose list overflowed, at its first rejected request, -1
    elsewhere)."""
    E = vertices.shape[0]
    cap = nbr_table.shape[1]
    spare = nbr_table.shape[0] - 1
    key = vertices.to(torch.int64) * 2**32 + (new_ids.to(torch.int64) + 1)
    order = torch.sort(key, stable=True).indices
    v, u = vertices[order], new_ids[order]
    valid = v >= 0
    first = torch.ones(E, dtype=torch.bool, device=v.device)
    first[1:] = v[1:] != v[:-1]
    idx = torch.arange(E, device=v.device)
    group_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rows = row_of(v.clamp_min(0)).long()
    slot = deg_table[rows].long() + (idx - group_start)
    ok = valid & (slot < cap)
    nbr_table[torch.where(ok, rows, spare), torch.where(ok, slot, 0)] = u
    deg_table.index_add_(0, torch.where(valid, rows, spare), ok.to(deg_table.dtype))
    # degrees never exceed cap, so the first rejected request of a vertex
    # sits exactly at slot == cap
    over_v = torch.where(valid & (slot == cap), v, -1)
    return v, u, ok, over_v


def _shrink_overflow(
    st: BuildState,
    vertices: torch.Tensor,  # (O,) int32 distinct ids to re-prune, -1 pad
    pending_v: torch.Tensor,  # (E,) this round's rejected requests' vertices, -1 else
    pending_u: torch.Tensor,  # (E,) their new ids
    level_minus1: int,  # -1: layer 0
    metric: int,
    max_add: int,
) -> None:
    """Re-prune each overflowed list, in place, with the diversity heuristic
    over its entries and the first ``max_add`` rejected additions by new id
    (hnsw.hh:208-224). ``pending_v`` must hold only rejected requests, so
    that accepted ones, already in the list, are not counted twice. Only
    the vertices that are not -1 are scored: the JAX package's other rows
    write nothing."""
    keep = torch.nonzero(vertices >= 0).squeeze(1)
    if keep.numel() == 0:
        return
    v = vertices[keep].long()
    O = v.shape[0]
    l2 = metric == METRIC_L2
    cap0, cap_up = st.neighbors0.shape[1], st.upper_neighbors.shape[2]
    is_l0 = level_minus1 < 0
    cap = cap0 if is_l0 else cap_up
    if is_l0:
        exist = st.neighbors0[v]
    else:
        rows_u = st.upper_row[v].clamp_min(0).long()
        exist = torch.cat([st.upper_neighbors[rows_u, level_minus1],
                           _pads(O, cap0 - cap_up, v.device)], dim=1)
    # each vertex's rejected additions: its run of the sorted (vertex, new
    # id) keys, the first max_add of them
    E = pending_v.shape[0]
    pkey = torch.where(pending_v >= 0, pending_v.to(torch.int64) * 2**32
                       + (pending_u.to(torch.int64) + 1), torch.iinfo(torch.int64).max)
    sk = torch.sort(pkey).values
    pos = (torch.searchsorted(sk, v * 2**32)[:, None]
           + torch.arange(max_add, device=v.device))
    got = sk[pos.clamp_max(E - 1)]
    hit = (pos < E) & ((got >> 32) == v[:, None])
    adds = torch.where(hit, (got & 0xFFFFFFFF) - 1, -1).to(torch.int32)

    cand = torch.cat([exist, adds], dim=1)  # (O, 2M + max_add)
    q_ext, bias = _query_ext(st, v, l2)
    d = _dists(st, q_ext, bias, cand, l2)
    order = torch.sort(dist_id_key(d, cand), dim=1).indices
    d, cand = torch.gather(d, 1, order), torch.gather(cand, 1, order)
    safe = cand.clamp_min(0).long()
    sel, n_sel = select_heuristic(cand, d, st.vectors[safe], st.vec_sqnorms[safe],
                                  cap0, metric)
    if is_l0:
        st.neighbors0[v] = sel
        st.degree0[v] = n_sel
    else:
        st.upper_neighbors[rows_u, level_minus1] = sel[:, :cap_up]
        st.upper_degree[rows_u, level_minus1] = n_sel.clamp_max(cap)


# ---------------------------------------------------------------------------
# one insert round


def _write_own_l0(st: BuildState, ids, sel, n_sel, participate) -> None:
    """The new nodes' own layer-0 lists (each node owns its row)."""
    cap0 = st.neighbors0.shape[1]
    spare = st.neighbors0.shape[0] - 1
    rows = torch.where(participate, ids.clamp_min(0), spare).long()
    st.neighbors0[rows] = torch.cat(
        [sel, _pads(sel.shape[0], cap0 - sel.shape[1], sel.device)], dim=1)
    st.degree0[rows] = n_sel


def _write_own_upper(st: BuildState, ids, sel, n_sel, lvl_m1: int,
                     participate) -> None:
    """The new nodes' own lists at upper level ``lvl_m1 + 1``."""
    spare = st.upper_neighbors.shape[0] - 1
    cap_up = st.upper_neighbors.shape[2]
    rows = st.upper_row[ids.clamp_min(0).long()]
    rows = torch.where(participate & (rows >= 0), rows, spare).long()
    st.upper_neighbors[rows, lvl_m1] = sel[:, :cap_up]
    st.upper_degree[rows, lvl_m1] = n_sel.clamp_max(cap_up)


class RoundPlan(NamedTuple):
    """A round's planned writes, a function of the round-start state only:
    within a round the new ids are >= count, which no search reaches, so a
    round factors into a plan (searches and selections) and an apply
    (deterministic writes)."""

    batch_ids: torch.Tensor  # (B,) int32, -1 pad
    node_level: torch.Tensor  # (B,) int32, after demotions
    up_ids: torch.Tensor  # (B_up,) int32, -1 where absent
    sel_up: torch.Tensor  # (B_up, L_cap, M) int32, -1 where absent
    n_sel_up: torch.Tensor  # (B_up, L_cap) int32
    sel_l0: torch.Tensor  # (B, M) int32
    n_sel_l0: torch.Tensor  # (B,) int32
    up_overflow: torch.Tensor  # (1,) int32: nodes demoted to level 0


def _plan_level(
    st: BuildState, ids, q_ext, bias, ep, ep_d, lvl: int, participate,
    M_out: int, metric: int, ef: int, frontier: int, timings: dict | None,
):
    """Search and select on one level, read-only. Returns (sel, n_sel,
    next_ep, next_ep_d): the next level's entry is the best candidate found
    (the reference continues from the best of top_candidates,
    hnsw.hh:151-175)."""
    dev = st.device
    ep_in = torch.where(participate, ep, -1)
    with _timed(timings, "l0_search" if lvl == 0 else "upper_search", dev):
        beam = _search_level(st, q_ext, bias, ep_in, ep_d, lvl, ef, frontier,
                             metric == METRIC_L2)
    with _timed(timings, "select", dev):
        cand = torch.where(participate[:, None], beam.ids, -1)
        safe = cand.clamp_min(0).long()
        sel, n_sel = select_heuristic(cand, beam.dists, st.vectors[safe],
                                      st.vec_sqnorms[safe], M_out, metric)
        sel = torch.where(participate[:, None], sel, -1)
        n_sel = torch.where(participate, n_sel, 0)
    best_i, best_d = beam.ids[:, 0], beam.dists[:, 0]
    use = participate & (best_i >= 0)
    return sel, n_sel, torch.where(use, best_i, ep), torch.where(use, best_d, ep_d)


def _apply_level(st: BuildState, ids, sel, n_sel, lvl: int, metric: int,
                 max_add: int, timings: dict | None) -> None:
    """Write one level's planned lists in place: the own rows, then the
    reverse edges, then the re-prune of the lists that overflowed."""
    dev = st.device
    participate = n_sel > 0
    with _timed(timings, "own_rows", dev):
        if lvl == 0:
            _write_own_l0(st, ids, sel, n_sel, participate)
        else:
            _write_own_upper(st, ids, sel, n_sel, lvl - 1, participate)
    flat_v = sel.reshape(-1)
    flat_u = torch.where(flat_v >= 0, ids[:, None].expand_as(sel).reshape(-1), -1)
    with _timed(timings, "reverse_edges", dev):
        if lvl == 0:
            tables = (st.neighbors0, st.degree0, lambda x: x)
        else:
            tables = (st.upper_neighbors[:, lvl - 1, :], st.upper_degree[:, lvl - 1],
                      lambda x: st.upper_row[x.long()])
        sv, su, ok, over = _apply_reverse_edges(*tables, flat_v, flat_u)
    with _timed(timings, "reprune", dev):
        _shrink_overflow(st, over, torch.where(ok, -1, sv), su, lvl - 1, metric,
                         max_add)


def plan_round(
    st: BuildState,
    batch_ids: torch.Tensor,  # (B,) int32
    *,
    ef: int,
    frontier: int,
    metric: int,
    B_up: int,
    timings: dict | None = None,
) -> RoundPlan:
    """The read-only half of an insert round.

    The upper levels run on a compacted sub-batch of at most ``B_up`` nodes
    (most nodes are level 0), the lowest ids first. A node past that is
    demoted to level 0 for good (here and in ``apply_round``) rather than
    keeping a high level with empty upper lists, which could make it an
    unreachable entry point; ``up_overflow`` counts them."""
    l2 = metric == METRIC_L2
    dev = st.device
    valid = batch_ids >= 0
    safe = batch_ids.clamp_min(0).long()
    q_ext, bias = _query_ext(st, safe, l2)
    node_level = torch.where(valid, st.levels[safe], 0)
    is_up = valid & (node_level >= 1)
    order = torch.argsort(torch.where(is_up, batch_ids, INT32_MAX), stable=True)
    up_pos = order[:B_up]
    up_ok = is_up[up_pos]
    chosen = torch.zeros_like(is_up)
    chosen[up_pos] = up_ok
    overflow = is_up & ~chosen
    node_level = torch.where(overflow, 0, node_level)
    target = node_level.clamp_max(st.entry_level)
    with _timed(timings, "descent", dev):
        ep, ep_d = _greedy_to_level(st, q_ext, bias, target, l2)

    up_ids = torch.where(up_ok, batch_ids[up_pos], -1)
    uq_ext, u_bias = q_ext[up_pos], bias[up_pos]
    u_target = torch.where(up_ok, target[up_pos], -1)
    u_ep, u_ep_d = ep[up_pos], ep_d[up_pos]
    L_cap, M_up = st.upper_neighbors.shape[1:]
    n_up = up_pos.shape[0]
    sel_up = torch.full((n_up, L_cap, M_up), -1, dtype=torch.int32, device=dev)
    n_sel_up = torch.zeros((n_up, L_cap), dtype=torch.int32, device=dev)
    # a level runs only while some node takes part: up to the highest target
    top = int(u_target.max()) if n_up else -1
    for lvl in range(min(L_cap, top), 0, -1):
        participate = up_ok & (lvl <= u_target)
        sel, n_sel, u_ep, u_ep_d = _plan_level(
            st, up_ids, uq_ext, u_bias, u_ep, u_ep_d, lvl, participate, M_up,
            metric, ef, frontier, timings)
        sel_up[:, lvl - 1] = sel
        n_sel_up[:, lvl - 1] = n_sel
    ep[up_pos] = torch.where(up_ok, u_ep, ep[up_pos])
    ep_d[up_pos] = torch.where(up_ok, u_ep_d, ep_d[up_pos])

    sel_l0, n_sel_l0, _, _ = _plan_level(
        st, batch_ids, q_ext, bias, ep, ep_d, 0, valid, M_up, metric, ef,
        frontier, timings)
    return RoundPlan(batch_ids, node_level, up_ids, sel_up, n_sel_up, sel_l0,
                     n_sel_l0, overflow.sum(dtype=torch.int32)[None])


def apply_round(st: BuildState, plan: RoundPlan, *, metric: int, max_add: int,
                timings: dict | None = None) -> None:
    """The write half of an insert round, in place; deterministic in the
    plan. Upper levels first, top down, then layer 0; then the demotions,
    the entry point (the highest level so far, ties to the lowest id) and
    the count."""
    L_cap = st.upper_neighbors.shape[1]
    has = (plan.n_sel_up > 0).any(dim=0).tolist()
    for lvl in range(L_cap, 0, -1):
        if has[lvl - 1]:
            _apply_level(st, plan.up_ids, plan.sel_up[:, lvl - 1],
                         plan.n_sel_up[:, lvl - 1], lvl, metric, max_add, timings)
    _apply_level(st, plan.batch_ids, plan.sel_l0, plan.n_sel_l0, 0, metric,
                 max_add, timings)

    valid = plan.batch_ids >= 0
    safe = plan.batch_ids.clamp_min(0).long()
    cur = st.levels[safe]
    # a node planned below its draw is stored at the planned level; the
    # others (pads included) write their own level back, which amin keeps
    st.levels.scatter_reduce_(
        0, safe, torch.where(valid & (plan.node_level < cur), plan.node_level, cur),
        "amin")
    batch_max = torch.where(valid, plan.node_level, -1).max()
    cand_ep = torch.where(valid & (plan.node_level == batch_max), plan.batch_ids,
                          INT32_MAX).min()
    bmax, cep, added = torch.stack(
        [batch_max.long(), cand_ep.long(), valid.sum()]).tolist()
    if bmax > st.entry_level:
        st.entry_point, st.entry_level = cep, bmax
    st.count += added


def insert_round(
    st: BuildState,
    batch_ids: torch.Tensor | np.ndarray,  # (B,) = count..count+B-1, -1 pad
    *,
    ef: int,
    frontier: int,
    max_add: int,
    metric: int,
    B_up: int,
    timings: dict | None = None,
) -> None:
    """Insert one batch of nodes against the graph of all earlier rounds,
    in place. Given a ``timings`` dict, adds each stage's seconds (card
    synchronised) under the names of ``STAGES``."""
    batch_ids = torch.as_tensor(batch_ids, dtype=torch.int32).to(st.device)
    plan = plan_round(st, batch_ids, ef=ef, frontier=frontier, metric=metric,
                      B_up=B_up, timings=timings)
    apply_round(st, plan, metric=metric, max_add=max_add, timings=timings)


def upper_batch(B: int, M: int) -> int:
    """The upper levels' sub-batch for a round of B: about 4x the geometric
    expectation B / M, at least 8."""
    return max(8, min(B, 4 * B // max(M, 2) + 8))


# ---------------------------------------------------------------------------
# the whole build


def device_build_graph(
    vectors: np.ndarray,
    params: HNSWParams,
    *,
    batch_size: int = 512,
    first_batch: int = 32,
    level_cap: int = LEVEL_CAP,
    mesh=None,
    device: torch.device | str | None = None,
    timings: dict | None = None,
) -> GraphSoA:
    """Build the whole index with insert rounds on ``device`` (the CUDA card
    unless another is given) and return the native builder's GraphSoA
    layout. Rounds ramp from ``first_batch`` nodes, doubling up to
    ``batch_size``: early rounds stay small while the graph is sparse.
    Every search runs at ``params.ef_construction``. Given a ``timings``
    dict, the build adds each stage's seconds (``STAGES``) and the number
    of "rounds"."""
    if mesh is not None:
        raise NotImplementedError("the sharded build (mesh=) is not ported "
                                  "yet: ROADMAP A8c")
    n = vectors.shape[0]
    st = init_build_state(vectors, params, level_cap=level_cap, device=device)
    count = 1
    B = min(max(first_batch, 1), batch_size)
    while count < n:
        b = min(B, n - count)
        ids = np.full(B, -1, dtype=np.int32)
        ids[:b] = np.arange(count, count + b, dtype=np.int32)
        insert_round(st, ids, ef=params.ef_construction, frontier=4, max_add=2 * params.M,
                     metric=params.metric_id, B_up=upper_batch(B, params.M),
                     timings=timings)
        count += b
        if timings is not None:
            timings["rounds"] = timings.get("rounds", 0) + 1
        if B < batch_size:
            B = min(2 * B, batch_size)
    return build_state_to_graph(st, params)


def build_state_to_graph(st: BuildState, params: HNSWParams,
                         n: int | None = None) -> GraphSoA:
    """The graph of the state's first ``n`` nodes (all of them by default)
    as a host GraphSoA, the spare rows left out; the upper table keeps at
    least one row."""
    n = st.n if n is None else n
    levels = st.levels[:n].cpu().numpy()
    upper_row = st.upper_row[:n].cpu().numpy()
    used = int(upper_row.max()) + 1 if (levels > 0).any() else 0
    top = st.entry_level
    upper = st.upper_neighbors[: max(used, 1), : max(top, 1)].cpu().numpy()
    return GraphSoA(
        params=params,
        vectors=st.vectors[:n].cpu().numpy(),
        levels=levels,
        neighbors0=st.neighbors0[:n].cpu().numpy(),
        upper_row=upper_row,
        upper_neighbors=np.ascontiguousarray(upper),
        entry_point=st.entry_point,
        top_level=top,
    )


def make_sharded_insert_round(*args, **kwargs):
    """The data-parallel round over a device mesh is not ported."""
    raise NotImplementedError("the sharded insert round is not ported yet: "
                              "ROADMAP A8c")
