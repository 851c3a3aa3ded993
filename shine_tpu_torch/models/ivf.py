"""IVF (inverted-file) index: the port of ``shine_tpu/models/ivf.py``.

Rows are split into balanced clusters (k-means, then a nearest-first
assignment under a per-cluster capacity) and stored cluster-major as a
padded (C, cap, d) bf16 tensor, -1 ids and +inf norms on the pads. A query
scores every centroid, takes its ``p`` nearest (its probes), scores the
rows of those clusters densely and re-ranks the best ``rerank * k`` exactly
in f32 from the resident base (``ivf_search``). The routed search
(``ivf_routed_search``) sorts a batch by its queries' nearest probes, cuts
it into tiles of T queries, grants each tile the ``shared`` clusters its
queries wish for most, rank by rank (``route_batch``, ``_route_cols``, which
the routed split family shares), and scores each tile's queries against
those clusters' rows gathered once; queries granted too few of their own
wishes are served again per query (``IVFIndex.search_routed``'s fallback).

The JAX package runs both searches as XLA outside any Pallas kernel; the
port runs them as torch ops on the device of the index. The bf16 probe
products keep f32 results (the rows are widened to f32, which is exact, and
multiplied in full fp32), as XLA's ``preferred_element_type=float32`` does.

Two builds: ``build_ivf_layout`` (the rows on the host; the layout uploaded
once) and ``build_ivf_layout_device`` (the rows stay on the device; only each
row's R nearest centroids visit the host). The capacity assignment is numpy,
as in the JAX package, and gives the same result on the same inputs; the
balanced k-means refinement and the routed split build run the same rule
as torch sorts on the device of their rows (``_capacity_assign_torch``,
bit for bit the numpy answer). The
k-means runs in full fp32 on the device of its points; its sums and argmins
may differ from XLA's by ulps, so it is held to the JAX package by
tolerance, not bit for bit. The random draws of the device build (its
training sample, ``_draw_train_ids``; the initial centres,
``_draw_init_ids``) and of the farthest-point init (``parallel/placement.py``)
are the JAX package's ``jax.random`` draws from ``PRNGKey(seed)``, bit for
bit, through the port's threefry (``ops/threefry.py``), on the device of the
rows. The host build's training sample is numpy's, the JAX package's own
draw.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.ops import threefry
from shine_tpu_torch.ops.beam import smallest_positions
from shine_tpu_torch.ops.classmax import top_k
from shine_tpu_torch.ops.distance import (
    check_precision,
    cluster_sums,
    matmul_nt,
    pair_dots,
    pairwise_distance,
    query_sqnorms,
    rerank_topk,
    squared_norms,
)
from shine_tpu_torch.utils.timing import sync_clock


class IVFData(NamedTuple):
    """The IVF layout, every tensor on one device."""

    centroids: torch.Tensor  # (C, d) f32
    blocks: torch.Tensor  # (C, cap, d) bf16
    block_sq: torch.Tensor  # (C, cap) f32, +inf on pads (0 on real slots under IP)
    block_ids: torch.Tensor  # (C, cap) int32, -1 on pads
    vectors: torch.Tensor  # (n, d) f32, by id, for the exact re-rank
    sqnorms: torch.Tensor  # (n,) f32, zeros under IP

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.blocks.shape[1]


def _capacity_assign_host(
    choice: np.ndarray,  # (n, R) i32 — per-row nearest clusters, best first
    choice_d: np.ndarray,  # (n, R) f32
    num_clusters: int,
    cap,  # int, or (num_clusters,) per-cluster room
    v32: np.ndarray | None = None,  # only for the rare overflow fallback
    cents: np.ndarray | None = None,
    *,
    defer_residue: bool = False,
) -> np.ndarray:
    """Nearest-first capacity-bounded assignment (host, vectorized).

    Points take their rank-r choice in (distance, cluster)-sorted order
    while the cluster has room; overflow spills to rank r+1. The residue
    (no top-R choice had room) goes to the nearest open cluster, or, with
    ``defer_residue``, stays unassigned (-1) for the caller to place."""
    n, R = choice.shape
    assign = np.full(n, -1, dtype=np.int64)
    if np.ndim(cap) == 0:
        room = np.full(num_clusters, cap, dtype=np.int64)
    else:
        room = np.asarray(cap, dtype=np.int64).copy()
    for r in range(R):
        un = np.where(assign < 0)[0]
        if len(un) == 0:
            break
        c_r = choice[un, r]
        order = np.lexsort((choice_d[un, r], c_r))
        un, c_r = un[order], c_r[order]
        # rank within cluster group
        first = np.concatenate([[True], c_r[1:] != c_r[:-1]])
        group_start = np.maximum.accumulate(np.where(first, np.arange(len(c_r)), 0))
        rank = np.arange(len(c_r)) - group_start
        ok = rank < room[c_r]
        assign[un[ok]] = c_r[ok]
        np.subtract.at(room, c_r[ok], 1)
    if defer_residue:
        return assign
    # final fallback: any cluster with room, nearest-first by centroid dist
    un = np.where(assign < 0)[0]
    if len(un):
        if v32 is not None and cents is not None and len(un) <= 65536:
            open_cs = np.where(room > 0)[0]
            dtile = pairwise_distance(torch.from_numpy(v32[un]),
                                      torch.from_numpy(cents[open_cs])).numpy()
            pref = np.argsort(dtile, axis=1, kind="stable")
            for i, qi in enumerate(un):
                for c in open_cs[pref[i]]:
                    if room[c] > 0:
                        assign[qi] = c
                        room[c] -= 1
                        break
        else:
            # no vectors at hand: round-robin the open slots
            open_slots = np.repeat(
                np.arange(num_clusters), np.maximum(room, 0)
            )
            assign[un] = open_slots[: len(un)]
    assert (assign >= 0).all()
    return assign


def _f32_sort_keys(d: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2**32) that order f32 values as numpy's sorts do
    (-0.0 equal to 0.0, +inf last; the inputs hold no NaN)."""
    b = (d.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def _capacity_assign_torch(choice: torch.Tensor, choice_d: torch.Tensor,
                           num_clusters: int, cap, *,
                           defer_residue: bool = False) -> torch.Tensor:
    """``_capacity_assign_host`` on the device of ``choice`` (n, R) int32
    and ``choice_d`` (n, R) f32, with its answer bit for bit: each round
    orders the unplaced rows by one stable sort of a (cluster, distance)
    key, which is ``np.lexsort``'s order, ties kept in id order. The
    residue, unless deferred, takes the open slots round-robin (the host
    rule without vectors). Returns (n,) int64, -1 for a deferred row."""
    dev = choice.device
    n, R = choice.shape
    assign = torch.full((n,), -1, dtype=torch.int64, device=dev)
    room = torch.as_tensor(cap, dtype=torch.int64, device=dev).expand(num_clusters).clone()
    for r in range(R):
        un = torch.nonzero(assign < 0).flatten()
        if un.numel() == 0:
            break
        key = (choice[un, r].to(torch.int64) << 32) | _f32_sort_keys(choice_d[un, r])
        key, order = torch.sort(key, stable=True)
        un, c_r = un[order], key >> 32
        pos = torch.arange(len(un), device=dev)
        first = torch.ones(len(un), dtype=torch.bool, device=dev)
        first[1:] = c_r[1:] != c_r[:-1]
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        ok = rank < room[c_r]
        assign[un[ok]] = c_r[ok]
        room -= torch.bincount(c_r[ok], minlength=num_clusters)
    if not defer_residue:
        un = torch.nonzero(assign < 0).flatten()
        if un.numel():
            open_slots = torch.repeat_interleave(
                torch.arange(num_clusters, device=dev), room.clamp_min(0))
            assign[un] = open_slots[: len(un)]
    return assign


def _cluster_slots_torch(assign: torch.Tensor, num_clusters: int, cap: int) -> torch.Tensor:
    """``_cluster_slots`` on the device of ``assign`` (n,) int64: (C, cap)
    int32, cluster c's rows ascending by id, -1 in the rest."""
    dev = assign.device
    sa, order = torch.sort(assign, stable=True)
    first = torch.searchsorted(sa, torch.arange(num_clusters, device=dev))
    slot = torch.arange(len(sa), device=dev) - first[sa]
    inv = torch.full((num_clusters, cap), -1, dtype=torch.int32, device=dev)
    inv[sa, slot] = order.to(torch.int32)
    return inv


def _spatial_order_centroids(cents: np.ndarray, seed: int) -> np.ndarray:
    """Permutation that relabels clusters so that spatially near centroids
    get adjacent ids: a coarse k-means over the centroids (on the CPU)
    gives the macro order; within a macro group, order by distance to the
    group's mean. Without it, routed tile unions collapse."""
    from shine_tpu_torch.parallel.placement import _lloyd

    C = cents.shape[0]
    k = max(1, min(C // 8, 256))
    if k <= 1:
        return np.arange(C)
    cents_t = torch.from_numpy(np.ascontiguousarray(cents, dtype=np.float32))
    coarse, _ = _lloyd(cents_t, k=k, iters=15, seed=seed)
    d2 = pairwise_distance(cents_t, coarse).numpy()
    g = d2.argmin(axis=1)
    return np.lexsort((d2[np.arange(C), g], g))


def _draw_init_ids(n: int, k: int, seed: int, device=None) -> torch.Tensor:
    """The initial centres: k distinct row ids in [0, n),
    ``jax.random.choice(PRNGKey(seed), n, (k,), replace=False)``."""
    return threefry.choice(threefry.prng_key(seed), n, k, device=device)


def _lloyd_chunked(points: torch.Tensor, *, k: int, iters: int, seed: int,
                   chunk: int = 8192) -> torch.Tensor:
    """Lloyd iterations that never hold the (n, k) distance tile: each
    chunk's (chunk, k) scores live for one step; the centroid sums are
    ``cluster_sums`` of the step's assignment, the same on every run.
    Random-row init. n must be a multiple of ``chunk``. Returns (k, d) f32
    centroids."""
    n, d = points.shape
    xs = points.to(torch.float32)
    cents = xs[_draw_init_ids(n, k, seed, xs.device)]
    for _ in range(iters):
        csq = squared_norms(cents)
        assign = torch.cat([
            torch.argmin(csq[None, :] - 2.0 * matmul_nt(xs[lo:lo + chunk], cents),
                         dim=1)
            for lo in range(0, n, chunk)])
        sums, counts = cluster_sums(xs, assign, k)
        cents = torch.where(counts[:, None] > 0.5,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    return cents


def _lloyd_balance_refine(points: torch.Tensor, cents: torch.Tensor, *,
                          k: int, rounds: int = 3, R: int = 8,
                          chunk: int = 8192) -> torch.Tensor:
    """Capacity-aware refinement of Lloyd centroids: each round
    capacity-assigns the points (cap = ceil(n/k) a cluster, nearest-first
    over their top-R choices) and recomputes the centroids from that
    assignment, so that cells which would overflow pull their centroid
    into the dense region."""
    n = points.shape[0]
    cap_t = -(-n // k)
    xs = points.to(torch.float32)
    Rr = min(R, k)
    for _ in range(rounds):
        csq = squared_norms(cents)
        parts = [_nearest_r_chunk(xs[lo:lo + chunk], cents, csq, R=Rr)
                 for lo in range(0, n, chunk)]
        assign = _capacity_assign_torch(torch.cat([p[0] for p in parts]),
                                        torch.cat([p[1] for p in parts]), k, cap_t)
        sums, counts = cluster_sums(xs, assign, k)
        cents = torch.where(counts[:, None] > 0.5,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    return cents


def _nearest_r_chunk(x: torch.Tensor, cents: torch.Tensor, csq: torch.Tensor,
                     *, R: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The R nearest centroids of each row, exactly, with their true
    squared L2 distances (the capacity sort compares them across rows):
    (ids (m, R) int32, dists (m, R) f32), nearest first. The JAX package
    takes ``approx_max_k`` from 4096 centroids on a TPU; the port is exact
    at every C."""
    xf = x.to(torch.float32)
    dd = (xf * xf).sum(dim=-1, keepdim=True) - 2.0 * matmul_nt(xf, cents) + csq[None, :]
    idx = smallest_positions(dd, R)
    return idx.to(torch.int32), torch.gather(dd, 1, idx)


# --- the builds ---------------------------------------------------------------


def _nearest_choices(dtile: torch.Tensor, R: int) -> tuple[np.ndarray, np.ndarray]:
    """Each row's R nearest clusters, nearest first, with their distances,
    from its (m, C) distance tile: (choice (m, R) int32, choice_d (m, R)
    f32) as numpy, what ``np.argpartition`` and a stable ``np.argsort`` give
    (the JAX package's host rule). A row whose R+1 nearest distances are all
    different has one answer, which a sorted ``topk`` on the tile's device
    gives; a row with two equal distances there gets numpy's own answer, from
    its whole distance row, because numpy's selection order decides
    between the tied clusters."""
    r1 = min(R + 1, dtile.shape[1])
    vals, idx = torch.topk(dtile, r1, dim=1, largest=False, sorted=True)
    choice = idx[:, :R].to(torch.int32).cpu().numpy()
    choice_d = vals[:, :R].cpu().numpy()
    tied = torch.nonzero((vals[:, 1:] == vals[:, :-1]).any(dim=1)).flatten()
    if tied.numel():
        rows = tied.cpu().numpy()
        sub = dtile[tied].cpu().numpy()
        part = np.argpartition(sub, R - 1, axis=1)[:, :R]
        pd = np.take_along_axis(sub, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        choice[rows] = np.take_along_axis(part, order, axis=1)
        choice_d[rows] = np.take_along_axis(pd, order, axis=1)
    return choice, choice_d


def _cluster_slots(assign: np.ndarray, num_clusters: int, cap: int) -> np.ndarray:
    """(C, cap) int32: cluster c's rows, ascending by id, in its first
    slots; -1 in the rest."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    first = np.searchsorted(sa, np.arange(num_clusters))
    slot = np.arange(n, dtype=np.int64) - first[sa]
    inv = np.full((num_clusters, cap), -1, np.int32)
    inv[sa, slot] = order.astype(np.int32)
    return inv


def build_ivf_layout(
    vectors: np.ndarray,
    num_clusters: int,
    *,
    metric: int = METRIC_L2,
    train_size: int = 100_000,
    iters: int = 25,
    seed: int = 1234,
    cap_slack: float = 1.25,
    device: torch.device | str | None = None,
    timings: dict | None = None,
) -> IVFData:
    """Balanced clustering and the cluster-major layout of host rows, uploaded
    once to ``device`` (the CUDA card unless another is given).

    k-means (``_lloyd``, farthest-point init) on ``train_size`` rows drawn by
    numpy (the JAX package's draw), the centroids ordered in space; each
    row's 8 nearest centroids, in 65,536-row distance tiles on the device;
    then the nearest-first assignment under cap = ceil(cap_slack * n / C)
    (overflow spills to the next-nearest cluster with room) and the fill, on
    the host. Given a ``timings`` dict, the stages' seconds land in it
    (kmeans, choices, capacity_assign, fill, upload), the device
    synchronised at each clock read."""
    from shine_tpu_torch.parallel.placement import _lloyd

    dev = resolve_device(device)
    rec = timings if timings is not None else {}
    t0 = sync_clock(dev)
    n, d = vectors.shape
    v32 = np.ascontiguousarray(vectors, dtype=np.float32)
    rng = np.random.default_rng(seed)
    train = v32[rng.choice(n, min(train_size, n), replace=False)]
    cents, _ = _lloyd(torch.from_numpy(train).to(dev), k=num_clusters, iters=iters,
                      seed=seed)
    cents = cents.cpu().numpy()
    cents = cents[_spatial_order_centroids(cents, seed)]
    cents_dev = torch.from_numpy(cents).to(dev)
    t1 = sync_clock(dev)
    rec["kmeans"] = t1 - t0

    cap = int(np.ceil(cap_slack * n / num_clusters))
    # 8 choices: with 2-4, capacity overflow falls through to far clusters
    # that no probe visits
    R = min(8, num_clusters)
    choice = np.empty((n, R), dtype=np.int32)
    choice_d = np.empty((n, R), dtype=np.float32)
    for lo in range(0, n, 65536):
        hi = min(lo + 65536, n)
        dtile = pairwise_distance(torch.from_numpy(v32[lo:hi]).to(dev), cents_dev)
        choice[lo:hi], choice_d[lo:hi] = _nearest_choices(dtile, R)
        del dtile
    t2 = sync_clock(dev)
    rec["choices"] = t2 - t1

    assign = _capacity_assign_host(choice, choice_d, num_clusters, cap, v32, cents)
    t3 = sync_clock(dev)
    rec["capacity_assign"] = t3 - t2

    block_ids = _cluster_slots(assign, num_clusters, cap)
    valid = block_ids >= 0
    blocks = np.zeros((num_clusters, cap, d), dtype=np.float32)
    blocks[valid] = v32[block_ids[valid]]
    # numpy's sums, as the JAX package's, so the norms are the same bits
    if metric == METRIC_L2:
        block_sq = np.where(valid, (blocks * blocks).sum(-1), np.inf)
        sqn = (v32 * v32).sum(-1)
    else:
        block_sq = np.where(valid, 0.0, np.inf)
        sqn = np.zeros(n, np.float32)
    t4 = sync_clock(dev)
    rec["fill"] = t4 - t3

    data = IVFData(
        centroids=cents_dev,
        blocks=torch.from_numpy(blocks).to(dev).to(torch.bfloat16),
        block_sq=torch.from_numpy(block_sq.astype(np.float32)).to(dev),
        block_ids=torch.from_numpy(block_ids).to(dev),
        vectors=torch.from_numpy(v32).to(dev),
        sqnorms=torch.from_numpy(sqn.astype(np.float32)).to(dev),
    )
    rec["upload"] = sync_clock(dev) - t4
    return data


def _draw_train_ids(n: int, ts: int, seed: int, device=None) -> torch.Tensor:
    """The device build's training sample: ts distinct row ids in [0, n),
    ``jax.random.choice(PRNGKey(seed), n, (ts,), replace=False)``, the key
    that ``_lloyd_chunked`` then draws the initial centres from."""
    return threefry.choice(threefry.prng_key(seed), n, ts, device=device)


def _fill_blocks_device(v: torch.Tensor, inv: torch.Tensor, sq_v: torch.Tensor,
                        *, cchunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The cluster-major fill on the rows' device, ``cchunk`` clusters at a
    time: (blocks (C, cap, d) bf16, 0 on a pad; block_sq (C, cap) f32, +inf
    on a pad) of the slot table ``inv`` (C, cap). Peak memory is the bf16
    blocks and one chunk's f32 rows. (The JAX package pads C to a multiple
    of ``cchunk`` for its scan; here the last chunk is only shorter.)"""
    C, cap = inv.shape
    blocks = torch.empty((C, cap, v.shape[1]), dtype=torch.bfloat16, device=v.device)
    bsq = torch.empty((C, cap), dtype=torch.float32, device=v.device)
    for c0 in range(0, C, cchunk):
        ic = inv[c0:c0 + cchunk]
        valid = ic >= 0
        safe = ic.clamp_min(0).long()
        blocks[c0:c0 + cchunk] = torch.where(valid[..., None],
                                             v[safe].to(torch.bfloat16), 0)
        bsq[c0:c0 + cchunk] = torch.where(valid, sq_v[safe], torch.inf)
    return blocks, bsq


def build_ivf_layout_device(
    v_dev: torch.Tensor,
    num_clusters: int,
    *,
    metric: int = METRIC_L2,
    train_size: int = 262_144,
    iters: int = 20,
    seed: int = 1234,
    cap_slack: float = 1.25,
    assign_chunk: int = 16_384,  # the (chunk, C) f32 tile lives beside the base
    fill_chunk: int = 1024,
    timings: dict | None = None,
) -> IVFData:
    """The IVF layout of rows that stay on their device (``v_dev``): only each
    row's R nearest centroids go to the host, for the capacity assignment.
    The same capacity scheme and block layout as ``build_ivf_layout``: a
    training sample drawn without replacement (``_draw_train_ids``),
    chunked k-means (``_lloyd_chunked``), the spatial order, R=8 choices in
    ``assign_chunk`` slices, the assignment (its residue round-robin over
    the open slots: no rows on the host) and the fill on the device. Stage
    seconds land in ``timings`` as in ``build_ivf_layout``."""
    rec = timings if timings is not None else {}
    dev = v_dev.device
    t0 = sync_clock(dev)
    n = v_dev.shape[0]
    ts = min(train_size, n)
    lchunk = min(8192, ts)
    ts -= ts % lchunk
    if ts < num_clusters:
        raise ValueError("train_size must be >= num_clusters")
    if ts < 16 * num_clusters:
        # a few training rows a centroid: the centroids do not tile the
        # data, and the capacity assignment scatters rows into far clusters
        # the probes never visit
        print(
            f"# WARNING: train_size {ts} < 16*num_clusters "
            f"({16 * num_clusters}) — undertrained centroids degrade "
            "probe recall; raise train_size or lower num_clusters",
            file=sys.stderr,
        )
    train = v_dev[_draw_train_ids(n, ts, seed, dev)]
    cents = _lloyd_chunked(train, k=num_clusters, iters=iters, seed=seed, chunk=lchunk)
    del train
    order = _spatial_order_centroids(cents.cpu().numpy(), seed)
    cents = cents[torch.from_numpy(order).to(dev)]
    csq = squared_norms(cents)
    t1 = sync_clock(dev)
    rec["kmeans"] = t1 - t0

    R = min(8, num_clusters)  # as build_ivf_layout
    choice = np.empty((n, R), np.int32)
    choice_d = np.empty((n, R), np.float32)
    for lo in range(0, n, assign_chunk):
        hi = min(lo + assign_chunk, n)
        ii, dd = _nearest_r_chunk(v_dev[lo:hi], cents, csq, R=R)
        choice[lo:hi] = ii.cpu().numpy()
        choice_d[lo:hi] = dd.cpu().numpy()
    t2 = sync_clock(dev)
    rec["choices"] = t2 - t1

    cap = int(np.ceil(cap_slack * n / num_clusters))
    assign = _capacity_assign_host(choice, choice_d, num_clusters, cap)
    inv = _cluster_slots(assign, num_clusters, cap)
    t3 = sync_clock(dev)
    rec["capacity_assign"] = t3 - t2

    inv_dev = torch.from_numpy(inv).to(dev)
    sq_v = squared_norms(v_dev)
    blocks, bsq = _fill_blocks_device(v_dev, inv_dev, sq_v, cchunk=fill_chunk)
    if metric != METRIC_L2:
        bsq = torch.where(inv_dev >= 0, 0.0, torch.inf)
        sq_v = torch.zeros_like(sq_v)
    rec["fill"] = sync_clock(dev) - t3
    return IVFData(centroids=cents, blocks=blocks, block_sq=bsq, block_ids=inv_dev,
                   vectors=v_dev, sqnorms=sq_v)


# --- the searches -------------------------------------------------------------


def ivf_stage1(data: IVFData, queries: torch.Tensor, *, metric: int) -> torch.Tensor:
    """(B, C) centroid scores."""
    return pairwise_distance(queries.to(torch.float32), data.centroids, metric)


def _widened(blocks: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The probe blocks ``cols`` (..., pc) as f32: (..., pc, cap, d). The
    probe products multiply them in full fp32, so every bf16 x bf16 product
    is exact and the sums and results are f32, as XLA's
    ``preferred_element_type=float32`` gives; a product with a bf16 result
    would round every score to 8 bits."""
    check_precision()
    C, cap, d = blocks.shape
    # whole blocks by index_select: advanced indexing gathers 2-byte
    # elements one by one
    rows = torch.index_select(blocks.view(C, cap * d), 0, cols.reshape(-1))
    return rows.view(*cols.shape, cap, d).to(torch.float32)


def _scores(dots: torch.Tensor, qn: torch.Tensor, sqs: torch.Tensor,
            ids: torch.Tensor, metric: int) -> torch.Tensor:
    """Probe scores from the products: ||q||^2 - 2<q, v> + ||v||^2 (L2) or
    1 - <q, v> (IP), +inf where the slot's id is negative."""
    dd = qn - 2.0 * dots + sqs if metric == METRIC_L2 else 1.0 - dots
    return torch.where(ids >= 0, dd, torch.inf)


def ivf_search(
    data: IVFData,
    queries: torch.Tensor,  # (B, d)
    *,
    k: int,
    p: int,
    metric: int,
    rerank: int = 4,
    probe_chunk: int | None = None,
    approx_probes: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query probed search on the device of ``data``: centroid scores,
    each query's p nearest clusters (``top_k``: exact, the lower cluster
    first on a tie), the rows of those blocks scored densely from bf16
    values, the ``rerank * k`` best re-ranked exactly in f32. Returns (ids
    (B, k) int32, dists (B, k) f32). The block rows are scored by K1's
    ``gather_score`` (``ops/distance.py:pair_dots``), one fixed sum order
    per (query, row) on the card, so a query's result does not depend on
    its batch (ROADMAP C11).

    The probe blocks are scored ``probe_chunk`` probes at a time (default:
    all p on the card; on the CPU about 512 MB of gathered f32 rows a step,
    rounded down to a divisor of p); the result does not depend on it.
    ``approx_probes`` is the JAX package's opt-in to ``approx_max_k`` above
    4096 clusters, which is exact off a TPU; the port's probes are exact
    either way."""
    del approx_probes  # exact, as approx_max_k is off a TPU
    q = queries.to(torch.float32)
    B, d = q.shape
    cap = data.cap
    probes = top_k(-ivf_stage1(data, q, metric=metric), p)[1]  # (B, p)
    qb = q.to(torch.bfloat16).to(torch.float32)
    qn = query_sqnorms(q)[:, None]  # (B, 1)
    table = data.blocks.view(-1, d)
    slots = torch.arange(cap, dtype=torch.int64, device=q.device)
    pc = probe_chunk or (p if q.is_cuda else
                         max(1, min(p, (1 << 29) // max(B * cap * d * 4, 1))))
    pc = min(pc, p)
    while p % pc:
        pc -= 1
    dd = torch.empty((B, p * cap), dtype=torch.float32, device=q.device)
    flat_ids = data.block_ids[probes].reshape(B, p * cap)
    sqs = data.block_sq[probes].reshape(B, p * cap)
    for j in range(0, p, pc):
        rows = (probes[:, j:j + pc, None].to(torch.int64) * cap + slots).reshape(B, -1)
        dots = pair_dots(table, qb, rows)
        sl = slice(j * cap, (j + pc) * cap)
        dd[:, sl] = _scores(dots.reshape(B, pc * cap), qn, sqs[:, sl],
                            flat_ids[:, sl], metric)
    kk = min(max(rerank, 1) * k, p * cap)
    sel = top_k(-dd, kk)[1]
    cand = torch.gather(flat_ids, 1, sel)  # (B, kk)
    d_out, i_out = rerank_topk(data.vectors, data.sqnorms, q, cand, k, metric)
    return i_out, d_out


def _route_cols(probes_s: torch.Tensor, C: int, P: int):
    """Rank-major tile-shared column grant, by two sorts.

    probes_s: (G, T, p) each query's probe wishes, affinity-sorted. Every
    query's rank-r wish is considered before any query's rank r+1: wish
    (t, r) carries position r*T + t, each cluster's priority is its least
    position, and the P best-priority clusters win. Returns (cols (G, P)
    int32, the pad cluster C where fewer than P clusters were wished for;
    coverage, the granted share of all wishes (0-d f32); q_granted (G*T,)
    f32, each query's granted share)."""
    G, T, p = probes_s.shape
    TP = T * p
    dev = probes_s.device
    pos = torch.arange(TP, device=dev).reshape(p, T).T.expand(G, T, p).reshape(G, TP)
    comb = probes_s.to(torch.int64).reshape(G, TP) * TP + pos
    s = torch.sort(comb, dim=1).values
    k_s = s // TP
    pos_s = s % TP
    iota = torch.arange(TP, device=dev).expand(G, TP)
    is_first = torch.ones((G, TP), dtype=torch.bool, device=dev)
    is_first[:, 1:] = k_s[:, 1:] != k_s[:, :-1]
    seg_start = torch.cummax(torch.where(is_first, iota, 0), dim=1).values
    minpos_elem = torch.gather(pos_s, 1, seg_start)
    # second sort: the unique clusters by their least position
    val = torch.where(is_first, pos_s, TP)  # TP = +inf sentinel
    s2 = torch.sort(val * (C + 1) + k_s, dim=1).values[:, :P]
    val2 = s2 // (C + 1)
    cols = torch.where(val2 < TP, s2 % (C + 1), C).to(torch.int32)
    # positions are unique in a group, so "least position <= the P-th
    # unique least position" picks exactly the granted clusters' wishes
    thresh = torch.where(val2[:, -1:] < TP, val2[:, -1:], TP)
    granted = minpos_elem <= thresh
    coverage = granted.to(torch.float32).sum() * _recip(G * TP)
    g_flat = torch.zeros((G, TP), dtype=torch.float32, device=dev)
    g_flat.scatter_(1, pos_s, granted.to(torch.float32))
    q_granted = g_flat.reshape(G, p, T).sum(dim=1).reshape(G * T) * _recip(p)
    return cols, coverage, q_granted


def _recip(n: int) -> float:
    """The f32 reciprocal of n: XLA takes a mean as the sum times it, not
    as the sum divided by n, and the port's means follow it bit for bit."""
    return float(np.float32(1) / np.float32(n))


def route_batch(cents: torch.Tensor, q: torch.Tensor, *, metric: int, p: int,
                P: int, T: int, C: int):
    """Stage 1 of a routed batch: each query's p nearest centroids (exact),
    the affinity sort by (nearest, second nearest) probe, and the tile
    grants. Returns (perm, inv, cols, coverage, q_granted): ``q[perm]`` is
    the affinity-sorted batch, ``inv`` undoes it; ``cols``, ``coverage``
    and ``q_granted`` (in sorted order) are ``_route_cols``'."""
    B = q.shape[0]
    probes_ = top_k(-pairwise_distance(q, cents, metric), p)[1]
    perm, inv = affinity_order(probes_)
    cols, coverage, q_granted = _route_cols(
        probes_[perm].reshape(B // T, T, p), C, P)
    return perm, inv, cols, coverage, q_granted


def affinity_order(probes_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The affinity sort of a batch by its queries' (nearest, second
    nearest) probes (B, p), by two stable argsorts (the exact lexsort):
    (perm, inv), ``inv`` undoing ``perm``."""
    if probes_.shape[1] > 1:
        perm = torch.argsort(probes_[:, 1], stable=True)
        perm = perm[torch.argsort(probes_[perm, 0], stable=True)]
    else:
        perm = torch.argsort(probes_[:, 0], stable=True)
    return perm, torch.argsort(perm, stable=True)


def routed_step_bytes(P: int, cap: int, d: int, T: int) -> int:
    """The device bytes one tile of ``ivf_routed_search`` adds at its peak,
    the largest of its three stages: the P gathered blocks in bf16 beside
    their f32 copy (``_widened``); the f32 blocks beside the (T, P*cap) f32
    products and two more such buffers of ``_scores``' eager arithmetic;
    ``top_k`` over the scores, which holds them, their negation and three
    int64 keys: 32 bytes a score."""
    blocks, scores = P * cap * d, T * P * cap
    return max(blocks * 6, blocks * 4 + scores * 12, scores * 32)


def ivf_routed_search(
    data: IVFData,
    queries: torch.Tensor,  # (B, d)
    *,
    k: int,
    p: int,
    shared: int,
    tile: int,
    metric: int,
    rerank: int = 4,
    approx: bool = True,
    step_budget: int = 1_000_000_000,  # bytes a scan step; small values
    # force the streamed path (the tests take it)
):
    """Tile-shared routed search on the device of ``data``: ``route_batch``
    sorts the batch by its queries' two nearest probes and grants each tile
    of ``tile`` queries ``shared`` clusters (``_route_cols``); each tile's
    blocks are gathered once and scored for all its queries (bf16 values,
    f32 products and sums, as ``ivf_search``), streamed over groups of
    tiles that hold about ``step_budget`` bytes (``routed_step_bytes``); the best
    ``rerank * k`` of each query are re-ranked exactly in f32. A column past
    the granted clusters (the pad cluster C) scores +inf with id -1, as the
    JAX package's masked columns. ``approx`` is the JAX package's
    ``approx_max_k`` opt-in, exact off a TPU; the port is exact either way.

    Returns (ids (B, k), dists (B, k), coverage (0-d), q_granted (B,)) in
    the caller's query order; coverage is the granted share of all
    (query, rank < p) wishes, q_granted each query's share."""
    del approx  # exact, as approx_max_k is off a TPU
    B, d = queries.shape
    if B % tile:
        raise ValueError(f"batch {B} is not a multiple of tile {tile}")
    G, T = B // tile, tile
    C, cap = data.num_clusters, data.cap
    P = min(shared, C)
    q = queries.to(torch.float32)
    perm, inv, cols, coverage, q_granted = route_batch(
        data.centroids, q, metric=metric, p=p, P=P, T=T, C=C)
    q_s = q[perm]
    qf = q_s.reshape(G, T, d)
    qb = qf.to(torch.bfloat16).to(torch.float32)
    qn = (qf * qf).sum(dim=-1)[..., None]  # (G, T, 1)
    safe = torch.where(cols < C, cols, 0).long()
    ids = torch.where((cols < C)[..., None], data.block_ids[safe], -1)  # (G, P, cap)
    kk = min(max(rerank, 1) * k, P * cap)
    gc = max(1, min(G, step_budget // max(routed_step_bytes(P, cap, d, T), 1)))
    while G % gc:
        gc -= 1
    cand = torch.empty((G, T, kk), dtype=ids.dtype, device=q.device)
    flat_ids = ids.reshape(G, 1, P * cap)
    sqs = data.block_sq[safe].reshape(G, 1, P * cap)
    for g0 in range(0, G, gc):
        sl = slice(g0, g0 + gc)
        rows = _widened(data.blocks, safe[sl]).reshape(gc, P * cap, d)
        dots = torch.matmul(qb[sl], rows.transpose(1, 2))  # (gc, T, P*cap)
        dd = _scores(dots, qn[sl], sqs[sl], flat_ids[sl], metric)
        del rows, dots
        sel = top_k(-dd, kk)[1]
        del dd
        cand[sl] = torch.gather(flat_ids[sl].expand(gc, T, P * cap), -1, sel)
    d_out, i_out = rerank_topk(data.vectors, data.sqnorms, q_s, cand.reshape(B, kk),
                               k, metric)
    return i_out[inv], d_out[inv], coverage, q_granted[inv]


# --- the index ----------------------------------------------------------------


def _auto_clusters(n: int, target_cap: int, layout: str) -> int:
    """The JAX package's cluster-count rules: "fine" (per-query search) about
    ``target_cap`` rows a cluster; "routed" (tile-shared search) coarse
    clusters, C at most 2048 at any n, so that tile probe unions overlap."""
    if layout == "routed":
        return max(8, min(2048, -(-n // 128)))
    if layout != "fine":
        raise ValueError(f"unknown layout {layout!r} (use 'fine'|'routed')")
    return max(8, -(-n // target_cap))




class IVFIndex:
    """Clustered approximate index on one device; ``probes`` tunes recall as
    ef does in HNSW. ``layout="routed"`` picks the coarse cluster count that
    ``search_routed`` needs (``_auto_clusters``); the default fine layout
    serves the per-query ``search`` best. ``device=None`` means the CUDA
    card (``resolve_device``); the CPU only when asked for."""

    def __init__(
        self,
        vectors: np.ndarray,
        *,
        num_clusters: int | None = None,
        target_cap: int = 128,
        metric: str | int = "l2",
        train_size: int = 100_000,
        seed: int = 1234,
        layout: str = "fine",
        device: torch.device | str | None = None,
        timings: dict | None = None,
    ):
        self.metric = metric_id(metric)
        n = vectors.shape[0]
        if num_clusters is None:
            num_clusters = _auto_clusters(n, target_cap, layout)
        self.data = build_ivf_layout(
            vectors, num_clusters, metric=self.metric, train_size=train_size,
            seed=seed, device=device, timings=timings,
        )
        self.n = n

    @classmethod
    def from_layout(cls, data: IVFData, metric: str | int = "l2") -> "IVFIndex":
        """The index serving an existing layout, on the device of its
        tensors."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.data = data
        self.n = data.vectors.shape[0]
        return self

    @classmethod
    def from_device(
        cls,
        v_dev: torch.Tensor,
        *,
        num_clusters: int | None = None,
        target_cap: int = 128,
        metric: str | int = "l2",
        train_size: int = 262_144,
        iters: int = 20,
        seed: int = 1234,
        fill_chunk: int = 1024,
        layout: str = "fine",
        device: torch.device | str | None = None,
        timings: dict | None = None,
    ) -> "IVFIndex":
        """Build from rows already on ``device`` (moved there if not): the
        rows never visit the host (``build_ivf_layout_device``)."""
        v_dev = v_dev.to(resolve_device(device))
        if num_clusters is None:
            num_clusters = _auto_clusters(v_dev.shape[0], target_cap, layout)
        mid = metric_id(metric)
        return cls.from_layout(build_ivf_layout_device(
            v_dev, num_clusters, metric=mid, train_size=train_size, iters=iters,
            seed=seed, fill_chunk=fill_chunk, timings=timings,
        ), mid)

    @property
    def device(self) -> torch.device:
        return self.data.blocks.device

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 8,
        batch_size: int = 2048,
        rerank: int = 4,
        approx_probes: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-query probed search (``ivf_search``) in batches of
        ``batch_size``, the last padded with zero rows: (ids (nq, k) int32,
        dists (nq, k) f32) as numpy."""
        nq, d = queries.shape
        p = min(probes, self.data.num_clusters)
        batch_size = min(batch_size, max(nq, 1))
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            ii, dd = ivf_search(
                self.data, torch.from_numpy(q).to(self.device), k=k, p=p,
                metric=self.metric, rerank=rerank, approx_probes=approx_probes,
            )
            out_i[lo:hi] = ii[: hi - lo].cpu().numpy()
            out_d[lo:hi] = dd[: hi - lo].cpu().numpy()
        return out_i, out_d

    def search_routed(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 16,
        shared: int = 96,
        tile: int = 256,
        batch_size: int = 4096,
        rerank: int = 4,
        with_stats: bool = False,
        preloaded=None,
        fallback: float | None = None,
    ):
        """Affinity-routed tile-shared probing (``ivf_routed_search``), in
        batches of ``batch_size`` rounded up to a multiple of ``tile``.

        With ``fallback > 0`` (default 0.5), queries whose granted share of
        their own wishes is below it are served again by the per-query
        search in one batch padded to a power of two of at least 64, as the
        JAX package spills: on a coarse layout coverage is about 1 and
        nothing spills; on a fine one the spill keeps the per-query recall.
        0.0 turns it off. A query's answer does not depend on the spill
        batch's size (ROADMAP C11: K1 scores its probed rows and re-rank).
        ``preloaded``: ``preload``'s (queries on the device, count).
        ``with_stats`` adds a dict (probe_coverage, tiles, shared,
        fallback_queries) to the returned (ids, dists)."""
        if fallback is None:
            fallback = 0.5
        if self.data.num_clusters > 2560:
            print(
                f"# WARNING: search_routed on a fine layout "
                f"(C={self.data.num_clusters}): tile probe unions stop "
                "overlapping and coverage collapses — build with "
                "layout='routed' (coarse C<=2048) for this serving mode",
                file=sys.stderr,
            )
        nq, d = queries.shape
        p = min(probes, self.data.num_clusters)
        shared = min(shared, self.data.num_clusters)
        batch_size = max(tile, -(-min(batch_size, max(nq, 1)) // tile) * tile)
        if preloaded is not None:
            q_dev, nq_real = preloaded
            if nq_real != nq:
                raise ValueError("preloaded queries do not match this call")
            # preload() padded to its own batch size; pad to this one
            nq_pad = -(-q_dev.shape[0] // batch_size) * batch_size
            if nq_pad != q_dev.shape[0]:
                q_dev = torch.cat([q_dev, q_dev.new_zeros(
                    (nq_pad - q_dev.shape[0], d))])
        else:
            q_dev, _ = self.preload(queries, batch_size=batch_size)
            nq_pad = q_dev.shape[0]
        parts = [
            ivf_routed_search(
                self.data, q_dev[lo:lo + batch_size], k=k, p=p, shared=shared,
                tile=tile, metric=self.metric, rerank=rerank,
            )
            for lo in range(0, nq_pad, batch_size)
        ]
        out_i = torch.cat([x[0] for x in parts])[:nq].cpu().numpy()
        out_d = torch.cat([x[1] for x in parts])[:nq].cpu().numpy()
        cov = torch.stack([x[2] for x in parts]).sum() * _recip(len(parts))
        n_fb = 0
        if fallback > 0:
            g = torch.cat([x[3] for x in parts])[:nq].cpu().numpy()
            need = np.where(g < fallback)[0]
            n_fb = len(need)
            if n_fb:
                bucket = 1 << max(int(np.ceil(np.log2(n_fb))), 6)
                qs = np.zeros((bucket, d), np.float32)
                qs[:n_fb] = queries[need]
                fi, fd = ivf_search(
                    self.data, torch.from_numpy(qs).to(self.device), k=k, p=p,
                    metric=self.metric, rerank=rerank,
                )
                out_i[need] = fi[:n_fb].cpu().numpy()
                out_d[need] = fd[:n_fb].cpu().numpy()
        if with_stats:
            return out_i, out_d, {
                "probe_coverage": float(cov),
                "tiles": nq_pad // tile,
                "shared": shared,
                "fallback_queries": n_fb,
            }
        return out_i, out_d

    def preload(self, queries: np.ndarray, *, batch_size: int = 4096):
        """Stage the queries on the index's device once, zero-padded to a
        multiple of ``batch_size``: (q_dev, nq)."""
        nq, d = queries.shape
        q_all = np.zeros((-(-max(nq, 1) // batch_size) * batch_size, d), np.float32)
        q_all[:nq] = queries
        return torch.from_numpy(q_all).to(self.device), nq

    def routed_cost_counters(self, nq: int, k: int = 10, *, probes: int = 16,
                             shared: int = 96, tile: int = 256,
                             rerank: int = 4) -> dict:
        """Analytic cost of ``search_routed``: stage 1 scores all C centroids
        a query; each tile's ``shared`` probe blocks are gathered once and
        scored for all its queries."""
        C, cap, d = self.data.num_clusters, self.data.cap, self.data.vectors.shape[1]
        P = min(shared, C)
        kk = min(max(rerank, 1) * k, P * cap)
        n_tiles = -(-nq // max(tile, 1))
        return {
            "distance_computations": nq * (C + P * cap + kk),
            "scanned_rows": nq * P * cap,
            "hbm_gather_bytes": n_tiles * P * cap * d * 2
            + nq * (C * d * 4 // max(nq, 1) + kk * d * 4),
            "ici_exchange_bytes": 0,
        }

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 8,
                      batch_size: int = 2048, rerank: int = 4) -> dict:
        """Analytic cost of ``search``: every query scores all C centroids,
        densely scans p probe blocks of cap rows (bf16) and re-ranks
        ``rerank * k`` survivors in f32."""
        C, cap, d = self.data.num_clusters, self.data.cap, self.data.vectors.shape[1]
        p = min(probes, C)
        kk = min(max(rerank, 1) * k, p * cap)
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * (C + p * cap + kk),
            "scanned_rows": nq * p * cap,
            "hbm_gather_bytes": batches * C * d * 4
            + nq * (p * cap * d * 2 + kk * d * 4),
            "ici_exchange_bytes": 0,
        }
