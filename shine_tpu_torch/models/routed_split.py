"""Routed (cluster-pruned) serving over the split layout: the port of
``shine_tpu/models/routed_split.py``.

Rows are clustered by a balanced k-means (``models/ivf.py``), stored
cluster-major in the split layout (bf16, or int8 at 136 bytes a row at
d=128) with one pad cluster, and each batch scans only the clusters its
query tiles ask for. A batch's queries pick their ``probes`` nearest
centroids, are sorted by their two nearest so that neighbours share a
tile, and each tile of T queries is granted the P clusters its queries
wish for most, rank by rank (``models/ivf.py:route_batch``, which the IVF
family shares). The routed class-max scan (K4, ``ops/scan_routed.py``)
reduces each query's scores over those blocks to one best row a class
lane; the best ``kk`` lanes are re-ranked exactly in f32 from the resident
base. Queries whose own wishes were granted less
than ``fallback`` are served again in narrow tiles that grant every wish.

The build (``build_routed_split``) trains the centroids on a sample, streams
every row's R nearest centroids, assigns rows to clusters under a capacity
(nearest first, re-choosing the overflow among clusters with room) and
packs the rows in cluster order. Its random draws (the training sample,
the k-means init, the spatial order's first centre) come from
``torch.Generator``s seeded with ``seed`` on the CPU, so the CPU and the
card plan alike; the JAX package draws with ``jax.random``, so a seed gives
another plan there. ``row_source`` (rows regenerated from a key) is not
ported yet: the base stays resident on the device.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.models import ivf
from shine_tpu_torch.models.ivf import route_batch
from shine_tpu_torch.ops.beam import dist_id_key, smallest_positions
from shine_tpu_torch.ops.classmax import top_k
from shine_tpu_torch.ops.distance import (
    matmul_nt,
    rerank_topk,
    squared_norms,
)
from shine_tpu_torch.ops.scan_routed import aux_routed_layout_chunk, routed_classmax_scan
from shine_tpu_torch.ops.scan_split import (
    COMP_DTYPES,
    NEG,
    comp_width,
    pack_split_device,
    pack_split_query,
)

_ROW_SOURCE_MSG = ("row_source (rows regenerated from a key) is not ported "
                   "yet: ROADMAP A6")


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _auto_probes(C: int) -> int:
    """The JAX package's measured recall-0.95 probe frontier by cluster
    count: 16*ceil(C/4096), clamped to [32, 128]."""
    return min(128, max(32, 16 * -(-C // 4096)))


def _auto_knobs(C: int, probes: int, tile: int, shared: int):
    """The JAX package's measured (tile, shared) rule: T=64 and 6x probes
    below 4096 clusters, T=32 and 12x probes from there; never more than
    a tile can wish for (tile*probes) or than C. tile/shared <= 0 = auto."""
    if tile <= 0:
        tile = 32 if C >= 4096 else 64
    if shared <= 0:
        shared = (12 if C >= 4096 else 6) * probes
    return tile, min(shared, tile * probes, C)


def _spill_plan(n_need: int, probes: int, C: int):
    """The fallback spill: T=16 tiles granting every wish (shared =
    16*probes), in a power-of-two batch of at least 64 queries."""
    Ts = 16
    Ps = min(C, Ts * probes)
    bucket = 1 << max(int(np.ceil(np.log2(max(n_need, 1)))), 6)
    return Ts, Ps, bucket


def scan_select(comp, aux_r, gid, q_s, cols, *, T: int, cap: int, cls: int,
                kk: int) -> torch.Tensor:
    """The routed class-max scan and each query's top-kk survivors, as
    global row ids (-1 where the lane held no real row): (B, kk) int32 in
    the affinity-sorted order of ``q_s``."""
    B = q_s.shape[0]
    qpad = pack_split_query(q_s, comp.shape[1])
    best, code = routed_classmax_scan(comp, aux_r, qpad, cols, T=T, cap=cap, cls=cls)
    bestk, sel = top_k(best, kk)
    lrow = torch.gather(code, 1, sel).to(torch.int64)  # (B, kk) local rows
    g_of_q = torch.arange(B, device=q_s.device) // T
    trow = cols[g_of_q[:, None], lrow // cap].to(torch.int64) * cap + lrow % cap
    return torch.where(bestk > NEG / 2, gid[trow], -1)


def routed_split_search_at(cents, comp, aux_r, gid, base_dev, sqnorms, q, *,
                           k, p, P, T, kk, metric, C, cap, cls):
    """One routed batch of f32 queries ``q`` (B, d), B a multiple of T:
    routing, the routed scan and select, the exact f32 re-rank. Returns
    (dists (B, k), ids (B, k), coverage, q_granted (B,)) in the batch's
    own order."""
    perm, inv, cols, coverage, q_granted = route_batch(
        cents, q, metric=metric, p=p, P=P, T=T, C=C)
    q_s = q[perm]
    cand = scan_select(comp, aux_r, gid, q_s, cols, T=T, cap=cap, cls=cls, kk=kk)
    d_out, i_out = rerank_topk(base_dev, sqnorms, q_s, cand, k, metric)
    return d_out[inv], i_out[inv], coverage, q_granted[inv]


class RoutedSplitIndex:
    """Cluster-pruned serving on the clustered split tables, on the device
    of its tensors: ``centroids`` (C, d) f32, ``comp`` ((C+1)*cap or more
    rows, dpc) bf16 or int8 cluster-major with the pad cluster C,
    ``aux_r`` (C+1, 2*members, cls) f32, ``gid`` (rows,) int32 global row
    ids (-1 pad), and the resident f32 base with its squared norms (zeros
    for IP) for the exact re-rank. Build it with ``build_routed_split``."""

    def __init__(self, centroids, comp, aux_r, gid, n: int, dim: int,
                 metric: int, *, cls: int, cap: int | None = None,
                 row_source=None, base_dev=None, sqnorms=None):
        if row_source is not None:
            raise NotImplementedError(_ROW_SOURCE_MSG)
        self.centroids = centroids
        self.comp = comp
        self.aux_r = aux_r
        self.gid = gid
        self.n, self.dim = n, dim
        self.metric = metric
        self.cls = cls
        self.base_dev = base_dev
        self.sqnorms = sqnorms
        self.C = int(centroids.shape[0])
        # comp may carry ingest-pad rows past (C+1)*cap: the scan never
        # reads them (cols <= C)
        self.cap = int(cap) if cap is not None else int(comp.shape[0]) // (self.C + 1)
        self.last_coverage = None
        self.last_fallback = 0
        self.last_spill = np.zeros(0, np.int64)  # the queries the spill served

    @property
    def device(self) -> torch.device:
        return self.comp.device

    def recenter_routing(self, *, chunk: int = 262_144) -> None:
        """Replace each routing centroid with the mean of the rows its
        cluster holds (read from the resident base by ``gid``); a cluster
        that holds none keeps its centroid. A cluster's rows are one run of
        ``cap`` slots, so each mean is a plain row sum over the run, the
        same on every run (no float atomics); ``chunk`` bounds the rows
        gathered at once (at least one cluster)."""
        C, cap = self.C, self.cap
        d = self.centroids.shape[1]
        per = max(1, chunk // cap)  # clusters a step
        sums = torch.zeros((C, d), dtype=torch.float32, device=self.device)
        counts = torch.zeros(C, dtype=torch.float32, device=self.device)
        for c0 in range(0, C, per):
            c1 = min(c0 + per, C)
            ids = self.gid[c0 * cap:c1 * cap].view(c1 - c0, cap)
            valid = (ids >= 0).to(torch.float32)
            x = self.base_dev[ids.clamp_min(0).long()].to(torch.float32)
            sums[c0:c1] = (x * valid[..., None]).sum(dim=1)
            counts[c0:c1] = valid.sum(dim=1)
        self.centroids = torch.where(
            counts[:, None] > 0, sums / counts[:, None].clamp_min(1.0),
            self.centroids)

    def preload(self, queries: np.ndarray, *, batch_size: int = 2048):
        """Stage the queries on the device once, zero-padded to a multiple
        of ``batch_size``: (q_dev, nq)."""
        nq, d = queries.shape
        q_all = np.zeros((_round_up(max(nq, 1), batch_size), d), np.float32)
        q_all[:nq] = queries
        return torch.from_numpy(q_all).to(self.device), nq

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 0,
        shared: int = 0,
        tile: int = 0,
        kk: int = 0,
        batch_size: int = 2048,
        preloaded=None,
        with_dists: bool = True,
        fallback: float = 0.5,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tile-shared routed search: (ids (nq, k) int32, dists (nq, k)
        f32) as numpy. ``probes``: each query's wishes (<= 0: the measured
        auto rule); ``shared``: the clusters a tile is granted (P);
        ``tile``: queries a tile (T); ``kk``: scan survivors a query fed to
        the re-rank (default 8*k, at most cls). The granted share of all
        wishes lands in ``last_coverage``. With ``fallback > 0``, queries
        whose own granted share is below it are served again in T=16
        tiles that grant every wish; their count lands in
        ``last_fallback`` and their positions in ``last_spill``."""
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        probes = min(probes, self.C)
        if kk <= 0:
            kk = 8 * k
        kk = min(kk, self.cls)
        nq = queries.shape[0]
        batch_size = max(tile, _round_up(min(batch_size, max(nq, 1)), tile))
        if preloaded is None:
            preloaded = self.preload(queries, batch_size=batch_size)
        q_dev, nq_real = preloaded
        if nq_real != nq or q_dev.shape[0] % batch_size:
            raise ValueError("preloaded queries do not match this call")
        kw = dict(k=k, p=probes, kk=kk, metric=self.metric, C=self.C,
                  cap=self.cap, cls=self.cls)
        parts = [self._search_at(q_dev[lo:lo + batch_size], P=shared, T=tile, **kw)
                 for lo in range(0, q_dev.shape[0], batch_size)]
        out_d = torch.cat([p[0] for p in parts])[:nq]
        out_i = torch.cat([p[1] for p in parts])[:nq]
        self.last_coverage = float(np.mean(
            torch.stack([p[2] for p in parts]).cpu().numpy()))
        self.last_fallback = 0
        self.last_spill = np.zeros(0, np.int64)
        if fallback > 0:
            g_all = torch.cat([p[3] for p in parts])[:nq]
            need = torch.nonzero(g_all < fallback).flatten()
            self.last_fallback = int(need.numel())
            self.last_spill = need.cpu().numpy()
            if self.last_fallback:
                Ts, Ps, bucket = _spill_plan(self.last_fallback, probes, self.C)
                qs = torch.zeros((bucket, q_dev.shape[1]), dtype=torch.float32,
                                 device=q_dev.device)
                qs[:self.last_fallback] = q_dev[need]
                fb = self._search_at(qs, P=Ps, T=Ts, **kw)
                out_i[need] = fb[1][:self.last_fallback]
                out_d[need] = fb[0][:self.last_fallback]
        ids = out_i.cpu().numpy()
        dists = out_d.cpu().numpy() if with_dists else np.zeros((nq, k), np.float32)
        return ids, dists

    def _search_at(self, q, **kw):
        return routed_split_search_at(
            self.centroids, self.comp, self.aux_r, self.gid, self.base_dev,
            self.sqnorms, q.to(torch.float32), **kw)

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 0,
                      shared: int = 0, tile: int = 0) -> dict:
        """Analytic cost of a run; probes/tile/shared <= 0 resolve with the
        same auto rules as ``search``."""
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        groups = -(-nq // tile)
        row_bytes = self.comp.shape[1] * self.comp.element_size() + 12
        return {
            "distance_computations": nq * (self.C + shared * self.cap + 8 * k),
            "scanned_rows": nq * shared * self.cap,
            "hbm_gather_bytes": groups * shared * self.cap * row_bytes,
            "ici_exchange_bytes": 0,
        }


# --- builder ------------------------------------------------------------------


def _rowfn(base_dev: torch.Tensor):
    """Global ids (m,) -> (m, d) f32 rows of the resident base."""
    def rowfn(ids: torch.Tensor) -> torch.Tensor:
        return base_dev[ids.long()].to(torch.float32)
    return rowfn


def fold_gt_stream(rowfn, n: int, queries: np.ndarray, metric: int, *,
                   gt_k: int = 10, rchunk: int = 131_072,
                   device: torch.device | str = "cpu") -> np.ndarray:
    """Exact f32 ground truth (ids (nq, gt_k) int32, ascending by (dist,
    id)) by streaming row chunks through ``rowfn`` in id order; only one
    chunk is held at a time."""
    rchunk = min(rchunk, max(n, 1))
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    qn = (q * q).sum(dim=1)[:, None]
    nq = q.shape[0]
    best_key = torch.empty((nq, 0), dtype=torch.int64, device=q.device)
    best_i = torch.empty((nq, 0), dtype=torch.int64, device=q.device)
    for lo in range(0, n, rchunk):
        ids = torch.arange(lo, min(lo + rchunk, n), device=q.device)
        x = rowfn(ids)
        dots = matmul_nt(q, x)
        dd = (qn - 2.0 * dots + squared_norms(x)[None, :]
              if metric == METRIC_L2 else 1.0 - dots)
        all_key = torch.cat([best_key, dist_id_key(dd, ids.expand(nq, -1))], 1)
        all_i = torch.cat([best_i, ids.expand(nq, -1)], 1)
        best_key, sel = torch.topk(all_key, min(gt_k, all_key.shape[1]), dim=1,
                                   largest=False)
        best_i = torch.gather(all_i, 1, sel)
    return best_i.to(torch.int32).cpu().numpy()


def _draw_train_ids(n: int, ts: int, seed: int) -> torch.Tensor:
    """The seeded training sample: ts row ids drawn in [0, n) with
    replacement."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (ts,), generator=gen)


def _cluster_major_order(assign: np.ndarray, C: int, cap: int) -> np.ndarray:
    """((C+1)*cap,) int32: cluster c's rows, ascending by id, in slots
    c*cap .., -1 in the empty slots and in the pad cluster C."""
    return np.concatenate([ivf._cluster_slots(assign, C, cap).reshape(-1),
                           np.full(cap, -1, np.int32)])


def _plan_routed(n, dim, *, rowfn, cap_target, cls, cap_slack, train_size,
                 kmeans_iters, seed, say, assign_r=8,
                 device: torch.device | str = "cpu"):
    """Stages A-C of the routed build: train the centroids, stream each
    row's ``assign_r`` nearest centroids, assign rows to clusters under the
    capacity and lay them out cluster-major. Returns (centroids (C, d) f32
    on ``device``, order ((C+1)*cap,) int32 numpy with -1 for an empty
    slot, C, cap)."""
    cap = _round_up(max(cap_target, 4 * cls), 4 * cls)
    C = max(2, math.ceil(cap_slack * n / cap))
    t0 = time.perf_counter()

    # A: train on a sample of at least 96 rows a cluster (at most 2M rows)
    ts = min(max(train_size, min(96 * C, 2_097_152)), n)
    lchunk = min(8192, ts)
    ts -= ts % lchunk
    x_train = rowfn(_draw_train_ids(n, ts, seed).to(device))
    cents = ivf._lloyd_chunked(x_train, k=C, iters=kmeans_iters, seed=seed,
                               chunk=lchunk)
    cents = ivf._lloyd_balance_refine(x_train, cents, k=C, rounds=3, R=assign_r,
                                      chunk=lchunk)
    cents = cents.cpu().numpy()
    cents = cents[ivf._spatial_order_centroids(cents, seed)]
    cents_dev = torch.from_numpy(np.ascontiguousarray(cents)).to(device)
    del x_train
    say(f"# routed_split: trained C={C} cap={cap} on {ts} rows "
        f"({time.perf_counter() - t0:.2f} s)")

    # B: stream each row's R nearest centroids to the host
    t0 = time.perf_counter()
    csq = squared_norms(cents_dev)
    R = max(2, min(assign_r, C))
    choice = np.empty((n, R), np.int32)
    choice_d = np.empty((n, R), np.float32)
    sub = 8192  # the (sub, C) distance tile of one step
    for lo in range(0, n, sub):
        ids = torch.arange(lo, min(lo + sub, n), device=device)
        ii, dd = ivf._nearest_r_chunk(rowfn(ids), cents_dev, csq, R=R)
        choice[lo:lo + sub] = ii.cpu().numpy()
        choice_d[lo:lo + sub] = dd.cpu().numpy()
    say(f"# routed_split: assignment choices streamed ({n} rows, R={R}, "
        f"{time.perf_counter() - t0:.2f} s)")

    # C: capacity assignment; the residue (all R choices full) re-chooses
    # among the clusters that still have room, nearest first, in rounds
    t0 = time.perf_counter()
    assign = ivf._capacity_assign_host(choice, choice_d, C, cap, defer_residue=True)
    un = np.where(assign < 0)[0]
    widened = len(un)
    R2 = int(min(64, C))
    wchunk = 8_192
    for _ in range(4):
        if not len(un):
            break
        room = cap - np.bincount(
            np.maximum(assign, 0), weights=(assign >= 0), minlength=C
        )[:C].astype(np.int64)
        penalty = torch.from_numpy(
            np.where(room > 0, 0.0, np.inf).astype(np.float32)).to(device)
        cho2 = np.empty((len(un), R2), np.int32)
        cho2_d = np.empty((len(un), R2), np.float32)
        for lo in range(0, len(un), wchunk):
            xf = rowfn(torch.from_numpy(un[lo:lo + wchunk]).to(device))
            dd = ((xf * xf).sum(dim=-1, keepdim=True) - 2.0 * matmul_nt(xf, cents_dev)
                  + csq[None, :] + penalty[None, :])
            ii = smallest_positions(dd, R2)
            cho2[lo:lo + wchunk] = ii.to(torch.int32).cpu().numpy()
            cho2_d[lo:lo + wchunk] = torch.gather(dd, 1, ii).cpu().numpy()
        assign2 = ivf._capacity_assign_host(cho2, cho2_d, C, room, defer_residue=True)
        assign[un] = assign2
        un = un[assign2 < 0]
    if len(un):
        # nothing open near them: round-robin the open slots
        room = cap - np.bincount(
            np.maximum(assign, 0), weights=(assign >= 0), minlength=C
        )[:C].astype(np.int64)
        open_slots = np.repeat(np.arange(C), np.maximum(room, 0))
        assign[un] = open_slots[: len(un)]
    assert (assign >= 0).all()
    ranks = np.full(n, R, np.int16)
    for r in range(R - 1, -1, -1):
        ranks[assign == choice[:, r]] = r
    hist = np.bincount(ranks, minlength=R + 1).astype(np.float64) / n
    say(f"# routed_split: assign ranks r0={hist[0]:.4f} r1={hist[1]:.4f} "
        f"r2+={hist[2:R].sum():.4f} widened={widened / n:.6f} "
        f"rr={len(un) / n:.6f}")
    order = _cluster_major_order(assign, C, cap)
    say(f"# routed_split: capacity assign done (cap={cap}, "
        f"fill={n / (C * cap):.3f}, {time.perf_counter() - t0:.2f} s)")
    return cents_dev, order, C, cap


def pack_clustered(base_dev: torch.Tensor, gid: torch.Tensor, metric: int, *,
                   cap: int, cls: int, comp_dtype: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The split tables of the rows ``gid`` names, in its cluster-major
    order ((C+1)*cap slots, -1 for an empty one), packed on the base's
    device a few clusters at a time: (comp ((C+1)*cap, dpc), aux_r (C+1,
    2*cap/cls, cls)). Empty slots are pad rows: comp 0, nrm NEG."""
    if comp_dtype not in COMP_DTYPES:
        raise ValueError(f"comp_dtype must be 'bf16' or 'int8', got {comp_dtype!r}")
    n_pad = gid.shape[0]
    rchunk = min(_round_up(65_536, cap), n_pad)  # whole clusters a step
    dev = base_dev.device
    comp = torch.empty((n_pad, comp_width(base_dev.shape[1])),
                       dtype=COMP_DTYPES[comp_dtype], device=dev)
    aux_r = torch.empty((n_pad // cap, 2 * (cap // cls), cls),
                        dtype=torch.float32, device=dev)
    for lo in range(0, n_pad, rchunk):
        ids = gid[lo:lo + rchunk]
        valid = ids >= 0
        x = base_dev[ids.clamp_min(0).long()].to(torch.float32)
        x = torch.where(valid[:, None], x, 0.0)
        comp_c, aux_c = pack_split_device(x, metric, comp_dtype=comp_dtype)
        aux_c[0] = torch.where(valid, aux_c[0], NEG)
        comp[lo:lo + ids.shape[0]] = comp_c
        aux_r[lo // cap:(lo + ids.shape[0]) // cap] = aux_routed_layout_chunk(
            aux_c, cap, cls)
    return comp, aux_r


def build_routed_split(
    n: int,
    dim: int,
    *,
    row_source=None,
    base_dev: torch.Tensor | None = None,
    metric: str | int = "l2",
    cap_target: int = 4096,
    cls: int = 1024,
    cap_slack: float = 1.05,
    comp_dtype: str = "int8",
    train_size: int = 131_072,
    kmeans_iters: int = 20,
    seed: int = 1234,
    assign_r: int = 8,
    queries: np.ndarray | None = None,
    gt_k: int = 10,
    log=None,
):
    """Build the clustered split tables of the resident base ``base_dev``
    (n, dim) on its device.

    cap is ``cap_target`` rounded up to a multiple of 4*cls, and C =
    ceil(cap_slack*n/cap) clusters follow (at least 2; the JAX package's
    ``shards`` rounding belongs to the sharded build, not ported), plus a
    pad cluster C (nrm NEG,
    gid -1) that takes ungranted columns. Stages: A. train balanced
    k-means centroids on a sample and order them in space; B. stream each
    row's ``assign_r`` nearest centroids; C. assign under the capacity,
    nearest first, and lay out cluster-major; D. pack the rows in that
    order. With ``queries``, the exact ground truth is folded first.
    Returns the index, or (index, gt) when ``queries`` is given."""
    if row_source is not None:
        raise NotImplementedError(_ROW_SOURCE_MSG)
    if base_dev is None:
        raise ValueError("build_routed_split needs base_dev, the resident rows")
    metric = metric_id(metric)
    say = log if log is not None else (lambda *_: None)
    dev = base_dev.device
    rowfn = _rowfn(base_dev)
    if tuple(base_dev.shape) != (n, dim):
        raise ValueError(f"base_dev is {tuple(base_dev.shape)}, not ({n}, {dim})")
    cents_dev, order, C, cap = _plan_routed(
        n, dim, rowfn=rowfn, cap_target=cap_target, cls=cls,
        cap_slack=cap_slack, train_size=train_size,
        kmeans_iters=kmeans_iters, seed=seed, say=say, assign_r=assign_r,
        device=dev)
    gt_i = None
    if queries is not None:
        gt_i = fold_gt_stream(rowfn, n, queries, metric, gt_k=gt_k, device=dev)
        say("# routed_split: exact ground truth folded")
    t0 = time.perf_counter()
    gid = torch.from_numpy(order).to(dev)
    comp, aux_r = pack_clustered(base_dev, gid, metric, cap=cap, cls=cls,
                                 comp_dtype=comp_dtype)
    say(f"# routed_split: clustered tables packed "
        f"({time.perf_counter() - t0:.2f} s)")
    sq = (squared_norms(base_dev) if metric == METRIC_L2
          else torch.zeros(n, dtype=torch.float32, device=dev))
    idx = RoutedSplitIndex(cents_dev, comp, aux_r, gid, n, dim, metric, cls=cls,
                           cap=cap, base_dev=base_dev, sqnorms=sq)
    if queries is not None:
        return idx, gt_i
    return idx
