"""Batched HNSW k-NN search on one CUDA card (or the CPU): the PyTorch port
of ``shine_tpu/models/hnsw.py``.

B queries advance together through fixed-shape, masked traversal steps,
as in the JAX package (the reference's knn, src/hnsw/hnsw.hh:
253-307):

  1. seeds: a dense (B, U) fp32 sweep over the upper-level vertices
     (``entry_mode="dense"``), or the reference's greedy descent through
     the upper levels (``"descent"``);
  2. a multi-frontier beam on layer 0 (``ops/beam.py``); each step picks
     E frontier entries, gathers their neighbour lists, scores the new
     candidate rows and merges them into the beam (``ops/beam_step.py``);
  3. the beam's first k entries.

``lax.while_loop`` becomes a Python loop of ``beam_step`` calls with the
JAX package's lockstep termination, so the hop and distance counters
match. On a card each step is one launch of the fused kernel
(``csrc/gather_score.cu``), gated by the count of unsettled queries that
the previous launch left, and the loop reads that count back once every
``CHECK_EVERY`` launches; on the CPU the step is the plain twin and the
count is read after every step. The descent entry scores
through ``ops/gather_score.py``, the same scoring routine. Hence
``SearchParams.pallas_gather`` has no effect here, and the JAX package's
TPU tiling workarounds (the 128-lane packing of layer-0 lists and the
lane-padded rows) do not exist in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, HNSWParams, SearchParams
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.graph.soa import GraphSoA, build_graph
from shine_tpu_torch.ops.beam import Beam, beam_init, beam_merge
from shine_tpu_torch.ops.beam_step import beam_step, settle_limit, unsettled_count
from shine_tpu_torch.ops.distance import matmul_nt, squared_norms
from shine_tpu_torch.ops.gather_score import gather_score

# dense-entry sweep chunk: above this many upper vertices the one-shot
# (B, U) f32 tile is streamed in U-chunks with a running top-m
ENTRY_UCHUNK = 131_072
# beam steps launched on a card between two reads of the unsettled count:
# up to CHECK_EVERY - 1 gated no-op launches (a few us each) at the end
# against one host round trip saved a step
CHECK_EVERY = 4


@dataclasses.dataclass
class DeviceGraph:
    """The search's graph tables, all on one ``torch.device``.

    Rows are stored at their natural width d, as f32, bf16 (exact f32
    distances to the bf16-rounded rows) or int8 with per-row scale and
    squared norm (distance = bias + <q_ext, row> * scl + nrm). The
    dense-entry table ``upper_vecs_ext`` stays f32.
    """

    vectors_ext: torch.Tensor  # (N, d) f32 | bf16 | int8
    neighbors0: torch.Tensor  # (N, 2M) int32, -1 pad
    upper_row: torch.Tensor  # (N,) int32, -1 on layer-0-only vertices
    upper_neighbors: torch.Tensor  # (U', L, M) int32
    upper_ids: torch.Tensor  # (U,) int32, global id of each upper vertex
    upper_vecs_ext: torch.Tensor  # (U, d) f32
    entry_point: int
    top_level: int
    row_scl: torch.Tensor | None = None  # (N,) f32, int8 rows only
    row_nrm: torch.Tensor | None = None  # (N,) f32 = ||row||^2, int8 rows

    @property
    def device(self) -> torch.device:
        return self.vectors_ext.device


def check_lists(neighbors0: np.ndarray, n: int) -> None:
    """Raise unless every layer-0 list entry is an id in [0, n) or the -1
    pad: the fused beam step reads rows by them unchecked."""
    nb = np.asarray(neighbors0)
    if nb.size and (int(nb.min()) < -1 or int(nb.max()) >= n):
        raise ValueError(f"neighbors0 holds ids outside [-1, {n}): "
                         f"[{int(nb.min())}, {int(nb.max())}]")


def quantize_rows(host_v: np.ndarray, rows: str) -> dict[str, torch.Tensor]:
    """Row storage on the host: the JAX package's numpy quantization, so
    the int8 tables are bit-identical; bf16 rounds to nearest even."""
    if rows == "f32":
        return {"vectors_ext": torch.from_numpy(host_v)}
    if rows == "bf16":
        return {"vectors_ext": torch.from_numpy(host_v).to(torch.bfloat16)}
    if rows == "int8":
        s = np.maximum(np.abs(host_v).max(axis=1), 1e-30)
        qv = np.clip(np.rint(host_v * (127.0 / s[:, None])), -127, 127)
        scl = (s / 127.0).astype(np.float32)
        nrm = ((qv * qv).sum(axis=1) * scl * scl).astype(np.float32)
        return {
            "vectors_ext": torch.from_numpy(qv.astype(np.int8)),
            "row_scl": torch.from_numpy(scl),
            "row_nrm": torch.from_numpy(nrm),
        }
    raise ValueError(f"rows must be f32|bf16|int8, got {rows!r}")


def device_graph(
    graph: GraphSoA, *, rows: str = "f32",
    device: torch.device | str | None = None,
) -> DeviceGraph:
    """Upload a host graph, with its rows stored as ``rows``, to ``device``
    (the CUDA card unless another is given)."""
    device = resolve_device(device)
    upper_ids = np.where(graph.levels >= 1)[0].astype(np.int32)
    if len(upper_ids) == 0:
        upper_ids = np.array([graph.entry_point], dtype=np.int32)
    host_v = np.ascontiguousarray(graph.vectors, dtype=np.float32)
    check_lists(graph.neighbors0, host_v.shape[0])
    tables = {
        "neighbors0": torch.from_numpy(np.ascontiguousarray(graph.neighbors0)),
        "upper_row": torch.from_numpy(np.ascontiguousarray(graph.upper_row)),
        "upper_neighbors": torch.from_numpy(
            np.ascontiguousarray(graph.upper_neighbors)),
        "upper_ids": torch.from_numpy(upper_ids),
        "upper_vecs_ext": torch.from_numpy(host_v[upper_ids]),
        **quantize_rows(host_v, rows),
    }
    return DeviceGraph(
        entry_point=int(graph.entry_point),
        top_level=int(graph.top_level),
        **{k: v.to(device) for k, v in tables.items()},
    )


def _extend_query(
    q: torch.Tensor, metric: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_ext (B, d), bias (B,)): dist = bias + q_ext . v [+ ||v||^2]."""
    if metric == METRIC_L2:
        return (-2.0 * q).contiguous(), (q * q).sum(dim=-1)
    return (-q).contiguous(), torch.ones(q.shape[0], dtype=q.dtype,
                                         device=q.device)


def _dist_ext(
    g: DeviceGraph, q_ext: torch.Tensor, bias: torch.Tensor,
    ids: torch.Tensor, l2: bool = True,
) -> torch.Tensor:
    """(B, K) distances of candidate ids (int32, -1 = masked -> inf)."""
    return gather_score(
        g.vectors_ext, q_ext, bias, ids.contiguous(), row_scl=g.row_scl,
        row_nrm=g.row_nrm if l2 else None, l2=l2,
    )


def _lex_better(d_new, i_new, d_old, i_old):
    """(dist, id) lexicographic improvement (reference heap.hh:53-57)."""
    return (d_new < d_old) | ((d_new == d_old) & (i_new < i_old))


def _greedy_descent(
    g: DeviceGraph,
    q_ext: torch.Tensor,
    bias: torch.Tensor,
    cur_id: torch.Tensor,  # (B,) int32
    cur_dist: torch.Tensor,  # (B,) f32
    level: int,
    l2: bool = True,
):
    """Greedy 1-NN walk on one upper level for the whole batch.
    Returns (id, dist, distance_computations) per query."""
    cid, cdist = cur_id, cur_dist
    moved = torch.ones_like(cid, dtype=torch.bool)
    dc = torch.zeros_like(cid)
    while bool(moved.any()):
        rows = g.upper_row[cid.clamp_min(0).long()].clamp_min(0).long()
        nbrs = g.upper_neighbors[rows, level - 1]  # (B, M)
        nbrs = torch.where(moved[:, None], nbrs, -1)
        d = _dist_ext(g, q_ext, bias, nbrs, l2=l2)
        j = torch.argmin(d, dim=1, keepdim=True)
        bd = torch.gather(d, 1, j)[:, 0]
        bi = torch.gather(nbrs, 1, j)[:, 0]
        better = _lex_better(bd, bi, cdist, cid) & moved
        cid = torch.where(better, bi, cid)
        cdist = torch.where(better, bd, cdist)
        dc = dc + (nbrs >= 0).sum(dim=1, dtype=torch.int32)
        moved = better
    return cid, cdist, dc


def _l0_state(seed_ids: torch.Tensor, seed_d: torch.Tensor, sp: SearchParams):
    """The layer-0 loop's state before its first step: (beam, seeded and
    contiguous; hops (B,); exact distance counts (B,); unsettled
    (max_steps + 1,), its entry 0 the count the seeded beam leaves)."""
    B, dev = seed_ids.shape[0], seed_ids.device
    beam = Beam(*(c.contiguous() for c in
                  beam_merge(beam_init(B, sp.ef, dev), seed_d, seed_ids)))
    hops = torch.zeros(B, dtype=torch.int32, device=dev)
    dists = torch.zeros(B, dtype=torch.int32, device=dev)
    unsettled = torch.zeros(sp.max_steps + 1, dtype=torch.int32, device=dev)
    unsettled[0] = unsettled_count(beam.expanded,
                                   settle_limit(sp.ef, sp.k, sp.term))
    return beam, hops, dists, unsettled


def _beam_search_l0_seeded(
    g: DeviceGraph,
    q_ext: torch.Tensor,  # (B, d)
    bias: torch.Tensor,  # (B,)
    seed_ids: torch.Tensor,  # (B, m) int32
    seed_d: torch.Tensor,  # (B, m) f32
    sp: SearchParams,  # resolved
    l2: bool = True,
    check_every: int | None = None,
) -> tuple[Beam, torch.Tensor, torch.Tensor, int]:
    """Layer-0 beam; returns (beam, hops (B,), exact distance counts (B,),
    steps). Steps run until every query's beam is settled (``term``) or
    ``max_steps`` have run. The unsettled count is read back every
    ``check_every`` steps (``CHECK_EVERY`` on a card, 1 on the CPU); the
    launches past the last active step are gated no-ops, so the result is
    the same for any interval."""
    state = _l0_state(seed_ids, seed_d, sp)
    t = run_beam_steps(g.vectors_ext, g.neighbors0, q_ext, bias, state, sp,
                       l2=l2, row_scl=g.row_scl, row_nrm=g.row_nrm,
                       check_every=check_every)
    beam, hops, dists, unsettled = state
    steps = int(torch.count_nonzero(unsettled[:t]))
    return beam, hops, dists, steps


def run_beam_steps(
    vectors: torch.Tensor,  # (N, d)
    neighbors0: torch.Tensor,  # (N, W) int32
    q_ext: torch.Tensor,
    bias: torch.Tensor,
    state: tuple,  # _l0_state's (beam, hops, counts, unsettled), in place
    sp: SearchParams,  # resolved
    *,
    l2: bool = True,
    row_scl: torch.Tensor | None = None,
    row_nrm: torch.Tensor | None = None,
    check_every: int | None = None,
) -> int:
    """The gated loop of ``beam_step`` launches over ``state`` and the list
    table ``neighbors0``; returns the number of launches. The graph search
    runs it on layer 0, the build (``models/build.py``) on every level."""
    every = check_every or (CHECK_EVERY if q_ext.device.type == "cuda" else 1)
    beam, hops, dists, unsettled = state
    t = 0
    while t < sp.max_steps and int(unsettled[t]) != 0:
        for _ in range(min(every, sp.max_steps - t)):
            beam_step(vectors, neighbors0, q_ext, bias, beam, hops, dists,
                      unsettled, t, frontier=sp.frontier, k=sp.k,
                      term=sp.term, l2=l2, row_scl=row_scl, row_nrm=row_nrm)
            t += 1
    return t


def _top_m(d: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the m smallest entries of each row of ``d``,
    ascending, ties to the lower position: what ``lax.top_k(-d, m)``
    gives (ROADMAP C4). m argmin passes, each taking the first minimum;
    ``d`` is overwritten. A row with fewer than m finite entries repeats
    a position among its +inf picks."""
    vals, pos = [], []
    for _ in range(m):
        j = torch.argmin(d, dim=1, keepdim=True)
        vals.append(torch.gather(d, 1, j))
        pos.append(j)
        d.scatter_(1, j, torch.inf)
    return torch.cat(vals, 1), torch.cat(pos, 1)


def _dense_entry(
    g: DeviceGraph, q_ext: torch.Tensor, bias: torch.Tensor, m: int, l2: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeds from a (B, U) fp32 sweep over the upper vertices: (ids (B, m)
    int32, dists (B, m)). Above ENTRY_UCHUNK vertices the sweep streams
    chunks with a running top-m."""
    B = q_ext.shape[0]
    U = g.upper_ids.shape[0]
    uchunk = ENTRY_UCHUNK
    dev = q_ext.device
    if U <= uchunk:
        du = bias[:, None] + matmul_nt(q_ext, g.upper_vecs_ext)
        if l2:
            du += squared_norms(g.upper_vecs_ext)[None, :]
        bd, bi = _top_m(du, m)
    else:
        bd = torch.full((B, m), torch.inf, dtype=torch.float32, device=dev)
        bi = torch.zeros((B, m), dtype=torch.int64, device=dev)
        for lo in range(0, U, uchunk):
            off = min(lo, U - uchunk)
            blk = g.upper_vecs_ext[off:off + uchunk]
            du = bias[:, None] + matmul_nt(q_ext, blk)
            if l2:
                du += squared_norms(blk)[None, :]
            # the clamped tail window (off < lo) re-covers ids that earlier
            # chunks scored; a duplicate in the running top-m would displace
            # a genuine m-th seed
            du[:, : lo - off] = torch.inf
            bd, pos = _top_m(torch.cat([bd, du], 1), m)
            idx = torch.cat([bi, torch.arange(off, off + uchunk, device=dev)
                             .expand(B, uchunk)], 1)
            bi = torch.gather(idx, 1, pos)
    return g.upper_ids[bi], bd


def batched_search(
    g: DeviceGraph,
    queries: torch.Tensor,  # (B, d)
    *,
    search_params: SearchParams,
    metric: int = METRIC_L2,
    with_stats: bool = False,
):
    """k-NN for a batch of queries. Returns (ids (B, k) int32, dists (B, k)
    f32) and, with ``with_stats``, the per-query hop and exact-distance
    counts."""
    ids, dists, hops, dc, _ = _search(g, queries, search_params.resolved(),
                                      metric)
    if with_stats:
        return ids, dists, hops, dc
    return ids, dists


def _seeds(g: DeviceGraph, q_ext: torch.Tensor, bias: torch.Tensor,
           sp: SearchParams, l2: bool):
    """The layer-0 seeds of ``sp.entry_mode``: (ids (B, m) int32, dists
    (B, m), the exact distances they cost per query)."""
    if sp.entry_mode == "dense":
        U = g.upper_ids.shape[0]
        ids, d = _dense_entry(g, q_ext, bias, min(sp.entry_seeds, U), l2)
        return ids, d, U  # the dense entry scores every upper vertex
    B = q_ext.shape[0]
    ep = torch.full((B,), g.entry_point, dtype=torch.int32, device=g.device)
    ep_dist = _dist_ext(g, q_ext, bias, ep[:, None], l2=l2)[:, 0]
    dc = torch.ones(B, dtype=torch.int32, device=g.device)
    for level in range(g.top_level, 0, -1):
        ep, ep_dist, d_lvl = _greedy_descent(
            g, q_ext, bias, ep, ep_dist, level, l2=l2
        )
        dc = dc + d_lvl
    return ep[:, None], ep_dist[:, None], dc


def _search(g: DeviceGraph, queries: torch.Tensor, sp: SearchParams,
            metric: int):
    """batched_search's body; also returns the number of beam steps."""
    q = queries.to(device=g.device, dtype=torch.float32)
    q_ext, bias = _extend_query(q, metric)
    l2 = metric == METRIC_L2
    seed_ids, seed_d, dc = _seeds(g, q_ext, bias, sp, l2)
    beam, hops, d_l0, steps = _beam_search_l0_seeded(
        g, q_ext, bias, seed_ids, seed_d, sp, l2=l2
    )
    return beam.ids[:, : sp.k], beam.dists[:, : sp.k], hops, d_l0 + dc, steps


class HNSWIndex:
    """Single-card index: host build (native C++) + batched device search.
    It runs on the CUDA card unless ``device`` names another."""

    def __init__(
        self, graph: GraphSoA, *, rows: str = "f32",
        device: torch.device | str | None = None,
    ):
        self.graph = graph
        self.device_graph = device_graph(graph, rows=rows, device=device)
        self.metric = graph.params.metric_id
        self.last_hops = 0
        self.last_dists = 0
        self.last_steps = 0

    @property
    def device(self) -> torch.device:
        return self.device_graph.device

    @classmethod
    def build(
        cls, vectors: np.ndarray, params: HNSWParams | None = None, *,
        rows: str = "f32", device: torch.device | str | None = None, **kw,
    ) -> "HNSWIndex":
        """Build the graph with the native builder, then upload it."""
        resolve_device(device)  # refuse before the build, not after it
        graph = build_graph(vectors, params or HNSWParams(), **kw)
        return cls(graph, rows=rows, device=device)

    def search(
        self,
        queries: np.ndarray,
        search_params: SearchParams | None = None,
        *,
        batch_size: int = 1024,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Search any number of queries in batches of ``batch_size``, the
        tail batch padded with zero queries. Sets ``last_hops`` and
        ``last_dists`` (expansions and exact distance computations, the
        reference's ThreadStatistics counters) for the real queries, and
        ``last_steps``, the layer-0 beam steps of all batches."""
        sp = (search_params or SearchParams()).resolved()
        nq, d = queries.shape
        out_i = np.empty((nq, sp.k), dtype=np.int32)
        out_d = np.empty((nq, sp.k), dtype=np.float32)
        self.last_hops = 0
        self.last_dists = 0
        self.last_steps = 0
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            chunk = np.zeros((batch_size, d), dtype=np.float32)
            chunk[: hi - lo] = queries[lo:hi]
            ids, dd, hops, dc, steps = _search(
                self.device_graph, torch.from_numpy(chunk), sp, self.metric
            )
            out_i[lo:hi] = ids[: hi - lo].cpu().numpy()
            out_d[lo:hi] = dd[: hi - lo].cpu().numpy()
            self.last_hops += int(hops[: hi - lo].sum())
            self.last_dists += int(dc[: hi - lo].sum())
            self.last_steps += steps
        return out_i, out_d
