"""Routed split serving over a cluster-sharded layout: the port of
``shine_tpu/parallel/routed_sharded.py``.

The clusters of a routed index (``models/routed_split.py``) are dealt
round-robin over the mesh: cluster c goes to shard ``c % S`` in local slot
``c // S``, and each shard holds its C/S clusters' split tables with its
own pad cluster last. A batch then runs on every shard:

  1. the probes, the affinity sort and the rank-major column grant
     (``models/ivf.py:_route_cols``) are the same on every shard, computed
     once a device from the replicated centroids;
  2. each shard compacts the granted columns it owns (a stable sort keeps
     the grant's priority order) into ``shared_local`` lanes, the rest
     pointing at its pad cluster, and scans them with the routed class-max
     scan (K4, ``scan_select``);
  3. the shards' (B, kk) survivor lanes carry global row ids and meet in
     one ``all_gather``; the union is re-ranked exactly once, on the first
     shard's device, from rows regenerated by id (``row_source``) or from
     the resident base.

A group granted more owned columns than ``shared_local`` drops the lowest
priority ones, counted in ``last_overflow``; the spill decision counts a
wish as served only if its cluster was scanned. ``build_routed_split_sharded``
plans as ``build_routed_split(shards=S)`` does and has each shard pack only
its own clusters' rows, so its tables equal ``from_single`` of that build,
bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from shine_tpu_torch.config import metric_id
from shine_tpu_torch.models.ivf import _recip, _route_cols, affinity_order
from shine_tpu_torch.models.routed_split import (
    _auto_knobs,
    _auto_probes,
    _plan_routed,
    _round_up,
    _spill_plan,
    fold_gt_stream,
    pack_clustered,
    scan_select,
)
from shine_tpu_torch.ops.classmax import top_k
from shine_tpu_torch.ops.distance import pairwise_distance, regen_rerank_topk, rerank_topk
from shine_tpu_torch.ops.regen import make_rowfn
from shine_tpu_torch.parallel.mesh import ShardMesh


class ShardedRoutedSplitIndex:
    """Cluster-sharded routed split serving on ``mesh``. Build a single
    index with ``build_routed_split(shards=S)`` and deal it with
    ``from_single``, or build directly with ``build_routed_split_sharded``.
    The tables are per-shard lists: ``comp`` ((C/S + 1) * cap, dpc),
    ``aux_r`` (C/S + 1, 2 * cap / cls, cls) and ``gid`` ((C/S + 1) * cap,)
    global row ids, each shard's pad cluster last."""

    def __init__(self, comp: list, aux_r: list, gid: list, centroids: torch.Tensor,
                 n: int, dim: int, metric: int, mesh: ShardMesh, *, C: int, cap: int,
                 cls: int, row_source=None, base=None):
        if row_source is None and base is None:
            raise ValueError("the exact re-rank needs row_source or base")
        self.mesh = mesh
        self.comp, self.aux_r, self.gid = mesh.put(comp), mesh.put(aux_r), mesh.put(gid)
        self.centroids = mesh.replicate(centroids.to(torch.float32))
        self.n, self.dim, self.metric = n, dim, metric_id(metric)
        self.C, self.cap, self.cls = C, cap, cls
        self.S = mesh.size
        self.C_loc = C // self.S
        dev0 = mesh.devices[0]
        self.row_source = row_source
        # the re-rank runs once, on the first shard's device
        self._rerank_src = (None if row_source is None
                            else (row_source[0], row_source[1].to(dev0)))
        self.base = None if base is None else tuple(t.to(dev0) for t in base)
        self.last_coverage = None
        self.last_overflow = None
        self.last_lanes = None
        self.last_fallback = 0

    @classmethod
    def from_single(cls, idx, mesh: ShardMesh) -> "ShardedRoutedSplitIndex":
        """Re-deal a ``RoutedSplitIndex``'s cluster blocks round-robin onto
        ``mesh`` (C must be a multiple of S: build with ``shards=S``). With
        a row source the re-rank regenerates rows by id; else the index's
        resident base (base mode, the command line's route) is kept on the
        first shard's device."""
        if idx.row_source is None and idx.base_dev is None:
            raise ValueError("sharded routed serving re-ranks exactly: it needs "
                             "the index's row_source or its base_dev")
        S = mesh.size
        C, cap = idx.C, idx.cap
        if C % S:
            raise ValueError(f"C={C} is not divisible by {S} shards; build with "
                             f"shards={S}")
        dpc = idx.comp.shape[1]
        n_pad = (C + 1) * cap  # the tables may carry ingest-pad rows past it
        comp = idx.comp[:n_pad].view(C + 1, cap, dpc)
        gid = idx.gid[:n_pad].view(C + 1, cap)
        parts = {"comp": [], "aux": [], "gid": []}
        for s in range(S):
            sel = torch.cat([torch.arange(s, C, S), torch.tensor([C])]).to(idx.comp.device)
            parts["comp"].append(comp[sel].reshape(-1, dpc))
            parts["aux"].append(idx.aux_r[sel].contiguous())
            parts["gid"].append(gid[sel].reshape(-1))
        base = None
        if idx.row_source is None:
            base = (idx.base_dev.to(torch.float32), idx.sqnorms)
        return cls(parts["comp"], parts["aux"], parts["gid"], idx.centroids, idx.n,
                   idx.dim, idx.metric, mesh, C=C, cap=cap, cls=idx.cls,
                   row_source=idx.row_source, base=base)

    def _plans(self, q: torch.Tensor, p: int, P: int, T: int) -> list:
        """The replicated routing, once a device, one entry a shard: (q_s,
        perm, inv, probes in sorted order (G, T, p), cols (G, P),
        coverage)."""
        B = q.shape[0]

        def plan(s):
            qd = q.to(self.mesh.devices[s])
            probes_ = top_k(-pairwise_distance(qd, self.centroids[s], self.metric), p)[1]
            perm, inv = affinity_order(probes_)
            pr_s = probes_[perm].reshape(B // T, T, p)
            cols, coverage, _ = _route_cols(pr_s, self.C, P)
            return qd[perm], perm, inv, pr_s, cols, coverage

        return self.mesh.per_device(plan)

    def shard_columns(self, s: int, pr_s: torch.Tensor, cols: torch.Tensor,
                      P_loc: int):
        """Shard s's share of a batch's grant ``cols`` (G, P): (its owned
        columns compacted in grant order to P_loc local clusters (G, P_loc)
        int32, the pad cluster C/S after them; the owned columns past the
        window; the lanes used; each query's count of its own wishes
        ``pr_s`` (G, T, p) that the window scans, f32 (G, T))."""
        S, C = self.S, self.C
        owned = (cols < C) & (cols % S == s)
        lcol = torch.where(owned, cols // S, self.C_loc)
        order = torch.argsort((~owned).to(torch.int32), dim=1, stable=True)
        lcol_c = torch.gather(lcol, 1, order)[:, :P_loc].contiguous()
        n_owned = owned.sum(dim=1)
        # a wish counts once its cluster is in its owner's window
        mine_w = (pr_s % S) == s
        hit = (((pr_s // S)[..., None] == lcol_c[:, None, None, :])
               & mine_w[..., None]).any(-1)
        return (lcol_c, (n_owned - P_loc).clamp_min(0).sum(),
                n_owned.clamp_max(P_loc).sum(), hit.to(torch.float32).sum(-1))

    def _batch(self, q: torch.Tensor, *, k: int, p: int, P: int, P_loc: int, T: int,
               kk: int):
        """One batch of f32 queries (B a multiple of T): (dists (B, k), ids
        (B, k), coverage, overflow, scanned-wish share (B,), lanes used),
        in the batch's order, on the first shard's device."""
        S = self.S
        B = q.shape[0]
        plans = self._plans(q, p, P, T)
        cands, overflow, lanes, scanned = [], [], [], []
        for s in range(S):
            q_s, _, _, pr_s, cols, _ = plans[s]
            lcol_c, over, used, hit = self.shard_columns(s, pr_s, cols, P_loc)
            overflow.append(over)
            lanes.append(used)
            scanned.append(hit.reshape(B) * _recip(p))
            cands.append(scan_select(self.comp[s], self.aux_r[s], self.gid[s], q_s,
                                     lcol_c, T=T, cap=self.cap, cls=self.cls, kk=kk))
        allc = self.mesh.all_gather(cands)[0].reshape(S, B, kk).transpose(0, 1)
        allc = allc.reshape(B, S * kk)
        q_s, _, inv, _, _, coverage = plans[0]
        if self._rerank_src is not None:
            d_out, i_out = regen_rerank_topk(*self._rerank_src, q_s, allc, k,
                                             self.metric)
        else:
            d_out, i_out = rerank_topk(*self.base, q_s, allc, k, self.metric)
        q_scanned = self.mesh.psum(scanned)[0]
        return (d_out[inv], i_out[inv], coverage, self.mesh.psum(overflow)[0],
                q_scanned[inv], self.mesh.psum(lanes)[0])

    def resolve_knobs(self, k: int, probes: int, shared: int, shared_local: int,
                      tile: int, kk: int):
        """The JAX package's rules: the routed family's auto probes, tile
        and shared; ``shared_local`` 2 * ceil(shared / S) + 2 (at most
        shared); ``kk`` 4k survivors a shard (at most cls)."""
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        probes = min(probes, self.C)
        if shared_local <= 0:
            shared_local = min(shared, 2 * (-(-shared // self.S)) + 2)
        if kk <= 0:
            kk = 4 * k
        return probes, shared, shared_local, tile, min(kk, self.cls)

    def search(self, queries: np.ndarray, k: int = 10, *, probes: int = 0,
               shared: int = 0, shared_local: int = 0, tile: int = 0, kk: int = 0,
               batch_size: int = 2048, fallback: float = 0.5
               ) -> tuple[np.ndarray, np.ndarray]:
        """Routed search over the mesh, the knobs as ``RoutedSplitIndex.
        search``'s plus ``shared_local`` (lanes a shard) and ``kk``
        survivors a shard. With ``fallback > 0`` the queries whose scanned
        share of their wishes is below it run again in T=16 tiles that
        grant every wish with no lane limit. Sets ``last_coverage``,
        ``last_overflow``, ``last_lanes`` and ``last_fallback``."""
        probes, shared, shared_local, tile, kk = self.resolve_knobs(
            k, probes, shared, shared_local, tile, kk)
        nq, d = queries.shape
        batch_size = max(tile, _round_up(min(batch_size, max(nq, 1)), tile))
        q_all = np.zeros((_round_up(max(nq, 1), batch_size), d), np.float32)
        q_all[:nq] = queries
        q_all = torch.from_numpy(q_all).to(self.mesh.devices[0])
        kw = dict(k=k, p=probes, kk=kk)
        parts = [self._batch(q_all[lo:lo + batch_size], P=shared, P_loc=shared_local,
                             T=tile, **kw)
                 for lo in range(0, q_all.shape[0], batch_size)]
        out_d = torch.cat([x[0] for x in parts])[:nq].cpu().numpy()
        out_i = torch.cat([x[1] for x in parts])[:nq].cpu().numpy()
        self.last_coverage = float(np.mean(
            torch.stack([x[2] for x in parts]).cpu().numpy()))
        self.last_overflow = int(sum(int(x[3]) for x in parts))
        self.last_lanes = int(sum(int(x[5]) for x in parts))
        self.last_fallback = 0
        if fallback > 0:
            g_all = torch.cat([x[4] for x in parts])[:nq]
            need = torch.nonzero(g_all < fallback).flatten().cpu().numpy()
            self.last_fallback = len(need)
            if len(need):
                Ts, Ps, bucket = _spill_plan(len(need), probes, self.C)
                qs = np.zeros((bucket, d), np.float32)
                qs[:len(need)] = queries[need]
                fb = self._batch(torch.from_numpy(qs).to(self.mesh.devices[0]),
                                 P=Ps, P_loc=Ps, T=Ts, **kw)
                out_i[need] = fb[1][:len(need)].cpu().numpy()
                out_d[need] = fb[0][:len(need)].cpu().numpy()
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 0,
                      shared: int = 0, shared_local: int = 0, tile: int = 0) -> dict:
        """The JAX package's analytic cost of a run; the knobs <= 0 resolve
        as in ``search``."""
        S = self.S
        probes, shared, shared_local, tile, _ = self.resolve_knobs(
            k, probes, shared, shared_local, tile, 0)
        kk = 4 * k
        groups = -(-nq // tile)
        row_bytes = self.comp[0].shape[1] * self.comp[0].element_size() + 12
        return {
            "distance_computations": nq * (self.C + shared * self.cap + S * kk),
            "scanned_rows": nq * min(shared, S * shared_local) * self.cap,
            "hbm_gather_bytes": groups * S * shared_local * self.cap * row_bytes,
            "ici_exchange_bytes": nq * kk * 4 * (S - 1) + nq * self.dim * 4 * (S - 1),
        }


def build_routed_split_sharded(
    n: int,
    dim: int,
    mesh: ShardMesh,
    *,
    row_source,
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
    """The routed build of a row-keyed base straight onto ``mesh``: the
    plan of ``build_routed_split(shards=S)`` (training, choices, capacity
    order) on the first shard's device, the exact ground truth folded
    there when ``queries`` are given, then each shard regenerates and packs
    only its own clusters' rows on its device. No single table is ever
    built; the tables equal ``from_single`` of the single build, bit for
    bit. Returns the index, or (index, gt) with ``queries``."""
    S = mesh.size
    metric = metric_id(metric)
    say = log if log is not None else (lambda *_: None)
    key, centers = row_source
    dev0 = mesh.devices[0]
    rowfn = make_rowfn((key, centers.to(dev0)), None, metric)
    cents_dev, order, C, cap = _plan_routed(
        n, dim, rowfn=rowfn, cap_target=cap_target, cls=cls, cap_slack=cap_slack,
        train_size=train_size, kmeans_iters=kmeans_iters, seed=seed, say=say,
        assign_r=assign_r, shards=S, device=dev0)
    gt_i = None
    if queries is not None:
        t0 = time.perf_counter()
        gt_i = fold_gt_stream(rowfn, n, queries, metric, gt_k=gt_k, device=dev0)
        say(f"# routed_split: exact ground truth folded "
            f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    order3 = order.reshape(C + 1, cap)
    comps, auxs, gids = [], [], []
    for s, (dev, cents_s) in enumerate(zip(mesh.devices, mesh.replicate(centers))):
        gid = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([order3[:C][s::S], order3[C:]]).reshape(-1))).to(dev)
        comp, aux_r = pack_clustered(make_rowfn((key, cents_s), None, metric), gid,
                                     metric, cap=cap, cls=cls, comp_dtype=comp_dtype)
        comps.append(comp)
        auxs.append(aux_r)
        gids.append(gid)
    say(f"# routed_split: per-shard clustered tables packed, {S} shards "
        f"({time.perf_counter() - t0:.2f} s)")
    idx = ShardedRoutedSplitIndex(comps, auxs, gids, cents_dev, n, dim, metric, mesh,
                                  C=C, cap=cap, cls=cls, row_source=row_source)
    if queries is not None:
        return idx, gt_i
    return idx
