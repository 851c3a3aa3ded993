"""Scan-speed HNSW construction: the port of ``shine_tpu/models/fastbuild.py``.

Instead of the reference's incremental insert (an ef_construction beam
search per node), the graph is built from an exact kNN table:

  1. scan the base against itself for each node's k nearest (the
     class-max scans K2/K3 of ``models/flat.py``, or with ``blockmax`` the
     block-max scan K5, on the card), exact-re-ranked in f32;
  2. select each node's M diverse neighbours with the reference's
     heuristic (``models/build.py:select_heuristic``), batched on the
     device;
  3. add reverse edges with nearest-first capping (the native
     ``reverse_merge``), then re-prune with the same heuristic;
  4. promote one node of every layer-0 component that no upper vertex
     reaches, and build the upper levels by the same recipe on their
     (small) subsets; the entry point is the lowest id of the top level.

With ``base_dev`` (the rows resident on a device) layer 0 runs as a
device self-sweep whose (n, k+1) table never leaves the device: each batch
of queries is a slice of the index's own rows, its self match is dropped,
and only the (n, M) selection comes back to the host. The sweep's table
layout comes from a memory plan (``_sweep_index``): the packed bf16 table,
else the split bf16 table, else the split int8 table, each at the largest
batch whose plan fits the card's free memory.

The JAX package's environment switches are keyword arguments here:
``hbm_bytes`` (SHINE_HBM_BYTES), ``layout`` (SHINE_SWEEP_SPLIT,
SHINE_SWEEP_INT8), ``host_select`` (SHINE_FASTBUILD_HOSTSEL), and the
stage times (SHINE_FASTBUILD_TIMING) go into a ``timings`` dict that the
caller passes.
``blockmax`` is the route the JAX package takes under ``interpret=True``.
A mesh (the sharded build) is not ported (ROADMAP A8c).
"""

from __future__ import annotations

import os
import time
import zipfile

import numpy as np
import torch

from shine_tpu_torch import native
from shine_tpu_torch.config import METRIC_L2, HNSWParams
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.graph.soa import GraphSoA
from shine_tpu_torch.models.build import draw_levels, select_heuristic
from shine_tpu_torch.models.flat import (
    FastFlatIndex,
    FlatIndex,
    SplitFlatIndex,
    fast_flat_search,
    split_flat_search,
)
from shine_tpu_torch.ops.distance import squared_norms
from shine_tpu_torch.ops.scan import pack_ext_query

HOST_KNN_MAX = 32_768  # the host path's kNN runs FlatIndex up to this many rows
SELECT_TILE_BYTES = 2_500_000_000  # a select batch's (C, C) tile and (C, d) gather
FLUSH_BYTES = 512_000_000  # staged select outputs a device-to-host copy
# the card's free memory less this much is the sweep's budget: the caching
# allocator's slack, cuBLAS workspaces and the batch transients the plan
# does not itemise
HEADROOM_BYTES = 4_000_000_000
LAYOUTS = ("ext", "bf16", "int8")  # the sweep's table ladder, widest first


def _select_batch(vdev, sdev, ci, cd, *, M_out, metric, with_dists=False):
    safe = ci.clamp_min(0).long()
    return select_heuristic(ci, cd, vdev[safe], sdev[safe], M_out, metric,
                            fill=True, with_dists=with_dists)


def _select_rows(batch: int, C: int, d: int) -> int:
    """Halve ``batch`` (to 256 at least) until its (batch, C, C) f32 tile
    and (batch, C, d) gather fit SELECT_TILE_BYTES (the JAX package's
    rule, which ``_sweep_plan`` mirrors). ``select_heuristic`` holds one
    bool tile beside the f32 one at its peak, 5 bytes a cell where the rule
    counts 4; that fifth byte, at most SELECT_TILE_BYTES / 4, rides
    HEADROOM_BYTES."""
    while batch > 256 and batch * C * (C + d) * 4 > SELECT_TILE_BYTES:
        batch //= 2
    return batch


def _device_select(vsel: torch.Tensor, ssel: torch.Tensor, cand: np.ndarray,
                   cand_d: np.ndarray, M_out: int, metric: int, *,
                   batch: int = 8192, with_dists: bool = False):
    """Batched diversity select on the device of ``vsel`` (n, d) rows and
    ``ssel`` norms, of candidates ``cand`` (B, C) sorted by (dist, id), -1
    padded, with distances ``cand_d``. Returns numpy (sel (B, M_out), n_sel
    (B,)[, sel_d (B, M_out)]). The batch is the power of two (at least 256)
    that covers B, at most ``batch``, halved under the tile rule; outputs
    come to the host in groups of about FLUSH_BYTES."""
    dev = vsel.device
    B, C = cand.shape
    batch = min(batch, 1 << max(8, (B - 1).bit_length()))
    batch = _select_rows(batch, C, int(vsel.shape[1]))
    out_bytes = batch * (M_out + 1) * 4 * (2 if with_dists else 1)
    group = max(1, FLUSH_BYTES // max(out_bytes, 1))
    pending: list = []
    host: list = []

    def flush():
        if pending:
            host.append(tuple(torch.cat(p).cpu().numpy() for p in zip(*pending)))
            pending.clear()

    for lo in range(0, B, batch):
        ci = torch.from_numpy(np.ascontiguousarray(cand[lo:lo + batch])).to(dev)
        cd = torch.from_numpy(np.ascontiguousarray(cand_d[lo:lo + batch],
                                                   dtype=np.float32)).to(dev)
        pending.append(_select_batch(vsel, ssel, ci, cd, M_out=M_out,
                                     metric=metric, with_dists=with_dists))
        if len(pending) >= group:
            flush()
    flush()
    return tuple(np.concatenate(parts) for parts in zip(*host))


def _drop_self_sorted(ii: np.ndarray, dd: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Remove the self match from rows sorted by (dist, id) and keep k
    columns: a one-slot shift left from the self hit, a (-1, inf) pad at the
    tail (what demoting the hit to the pad value and sorting again gives)."""
    n, w = ii.shape
    local = np.arange(n, dtype=ii.dtype)[:, None]
    self_hit = ii == local
    has = self_hit.any(axis=1)[:, None]
    h = np.argmax(self_hit, axis=1)[:, None]
    j = np.arange(w)[None, :]
    src = np.where(has & (j >= h), np.minimum(j + 1, w - 1), j)
    out_i = np.take_along_axis(ii, src, axis=1)
    out_d = np.take_along_axis(dd, src, axis=1)
    tail = has & (j == w - 1)
    out_i = np.where(tail, -1, out_i)
    out_d = np.where(tail, np.inf, out_d)
    return out_i[:, :k].astype(np.int32), out_d[:, :k].astype(np.float32)


def _drop_self_dev(ii: torch.Tensor, dd: torch.Tensor, lo: int, *, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``_drop_self_sorted`` for one sweep batch, whose row
    b has self id lo + b."""
    B, w = ii.shape
    dev = ii.device
    local = lo + torch.arange(B, dtype=ii.dtype, device=dev)[:, None]
    self_hit = ii == local
    has = self_hit.any(dim=1, keepdim=True)
    j = torch.arange(w, device=dev)[None, :]
    h = torch.where(self_hit, j, w).amin(dim=1, keepdim=True)
    src = torch.where(has & (j >= h), (j + 1).clamp_max(w - 1), j).expand(B, w)
    out_i = torch.gather(ii, 1, src)
    out_d = torch.gather(dd, 1, src)
    tail = has & (j == w - 1)
    out_i = torch.where(tail, -1, out_i)
    out_d = torch.where(tail, torch.inf, out_d)
    return out_i[:, :k], out_d[:, :k]


def _knn_candidates(vectors: np.ndarray, ids: np.ndarray, k: int, metric: int,
                    blockmax: bool, device: torch.device
                    ) -> tuple[np.ndarray, np.ndarray]:
    """kNN of the subset ``ids`` against itself, self excluded, on one
    device: (cand (n, k) global ids, dists (n, k)). Up to HOST_KNN_MAX rows,
    or under the block-max route, FlatIndex (bf16 scan and f32 re-rank; exact
    f32 under the block-max route, as the JAX package's interpret build
    does); else FastFlatIndex at kb = max(k + 17, 48) (128 from d = 512)."""
    sub = vectors[ids]
    n, d = sub.shape
    if n <= HOST_KNN_MAX or blockmax:
        idx = FlatIndex(sub, metric=metric, device=device)
        ii, dd = idx.search(sub, k + 1, batch_size=2048, use_bf16=not blockmax)
    else:
        idx = FastFlatIndex(sub, metric=metric, device=device)
        pre = idx.preload(sub, batch_size=4096)
        kb = max(k + 17, 48 if d < 512 else 128)
        ii, dd = idx.search(sub, k + 1, kb=kb, batch_size=4096, preloaded=pre)
    ii, dd = _drop_self_sorted(ii, dd, k)  # rows arrive sorted by (dist, id)
    gi = np.where(ii >= 0, ids[np.maximum(ii, 0)], -1)
    return gi.astype(np.int32), dd


def _hbm_budget(device: torch.device, hbm_bytes: float | None) -> float | None:
    """The sweep's memory budget: ``hbm_bytes`` when given, else on a card
    its free memory less HEADROOM_BYTES; None (unchecked) on the CPU."""
    if hbm_bytes is not None:
        return float(hbm_bytes)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return float(free - HEADROOM_BYTES)


def _sweep_plan(
    n: int, d: int, k: int, kb: int, batch: int, cls: int,
    layout: str, keep2: bool, sel_batch: int = 0, sel_width: int = 0,
    fused: bool = False, blockmax: bool = False,
) -> dict:
    """Itemised upper-bound bytes of the level-0 device sweep, computed
    before any allocation (the JAX package's arithmetic, with its table
    width of d + 2 rounded up to 128: the port's narrower table fits under
    it). ``fused``: the sweep and select pipeline, a few batches in flight
    and small flush buffers. ``blockmax``: the block-max route replaces the
    class-max outputs with K5's four (batch, n/128) 4-byte planes and the
    int64 keys of their select."""
    dp = -(-(d + 2) // 128) * 128
    classes = -(-n // cls)
    width = kb * (2 if keep2 or blockmax else 1)
    if fused and not sel_batch:
        sel_batch, sel_width = _select_rows(batch, k, d), k
    items = {
        "base_f32": n * d * 4,
        "sqnorms": n * 4,
        "table": (
            n * dp * 2 if layout == "ext"
            else n * d * (1 if layout == "int8" else 2) + 2 * n * 4
        ),
        # class-max outputs (m1/a1 [+ m2/a2]) and the select's scratch (~2x)
        "scan_classtable": (0 if blockmax
                            else batch * classes * 8 * (2 if keep2 else 1) * 3),
        "rerank_gather": batch * width * (d * 4 + 8) + batch * (k + 1) * 8,
        "select_tile": sel_batch * sel_width * (sel_width + d) * 4,
        "result_flush": (
            4 * batch * (k + 1) * 8 if fused
            else 64 * batch * (k + 1) * 8
        ),
    }
    if blockmax:
        items["scan_blocks"] = batch * (n // 128) * (16 + 8)
    items["total"] = sum(items.values())
    return items


def _check_sweep_plan(plan: dict, stage: str, budget: float | None) -> None:
    if budget is not None and plan["total"] > budget:
        lines = ", ".join(f"{k}={v / 1e9:.2f}GB" for k, v in plan.items()
                          if k != "total" and isinstance(v, (int, float)))
        raise RuntimeError(
            f"fastbuild {stage}: planned {plan['total'] / 1e9:.2f} GB exceeds "
            f"the budget of {budget / 1e9:.2f} GB ({lines}); shrink the batch "
            "or kb, or pass hbm_bytes for a larger card")


def _sweep_index(base_dev: torch.Tensor, k: int, metric: int, *,
                 blockmax: bool = False, fused: bool = False,
                 hbm_bytes: float | None = None, layout: str = "ext"):
    """The table layout and knobs of a device self-sweep. Returns (index,
    search_at(lo) -> (dists, ids) of rows lo .. lo + batch on the device,
    plan dict).

    The (layout, batch) configurations are tried in the order ext 4096,
    bf16 4096, bf16 2048, int8 4096, 2048, 1024, from the rung ``layout``
    down, and the first whose plan fits the budget wins. Every layout
    re-ranks exactly against the resident f32 rows; int8 widens kb to
    max(k + 64, 96), the others take max(k + 17, 48). The block-max route
    takes ext at min(4096, n) and checks its plan. The last batch may be
    short (the JAX package asks n to be a multiple of the batch). keep2 is
    on when (k + 1)^2 exceeds the class count: one winner a class loses
    ~k^2 / (2 * classes) true candidates to collisions."""
    n, d = base_dev.shape
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    cls = 1024
    keep2 = (k + 1) * (k + 1) > -(-n // cls)

    def kb_of(lay):
        return max(k + 64, 96) if lay == "int8" else max(k + 17, 48)

    budget = _hbm_budget(base_dev.device, hbm_bytes)
    if blockmax:
        layout, batch = "ext", min(4096, n)
        plan = _sweep_plan(n, d, k, kb_of(layout), batch, cls, layout, keep2,
                           fused=fused, blockmax=True)
        _check_sweep_plan(plan, f"block-max level-0 sweep (n={n})", budget)
    else:
        configs = [c for c in (("ext", 4096), ("bf16", 4096), ("bf16", 2048),
                               ("int8", 4096), ("int8", 2048), ("int8", 1024))
                   if LAYOUTS.index(c[0]) >= LAYOUTS.index(layout)]
        for lay, b in configs:
            plan = _sweep_plan(n, d, k, kb_of(lay), b, cls, lay, keep2,
                               fused=fused)
            if budget is None or plan["total"] <= budget:
                layout, batch = lay, b
                break
        else:
            layout, batch = configs[-1]
            plan = _sweep_plan(n, d, k, kb_of(layout), batch, cls, layout,
                               keep2, fused=fused)
            _check_sweep_plan(plan, f"level-0 sweep (n={n}, layout={layout})",
                              budget)
    kb = kb_of(layout)
    if layout == "ext":
        # no shuffle: the sweep slices its queries from the index's own rows
        # at row offsets and reads raw ids, which needs the original order
        idx = FastFlatIndex.from_device(base_dev, metric=metric, shuffle=False,
                                        blockmax=blockmax)
    else:
        idx = SplitFlatIndex.from_device(base_dev, metric=metric,
                                         comp_dtype=layout)

    def search_at(lo: int):
        qj = idx.vectors[lo:lo + batch]
        if layout != "ext":
            return split_flat_search(
                idx.comp, idx.aux, idx.vectors, idx.sqnorms, qj, k=k + 1,
                kb=kb, cls=cls, metric=metric, keep2=keep2, n=n)
        q_ext = pack_ext_query(qj, idx.dp).to(torch.bfloat16)
        return fast_flat_search(
            idx.ext, idx.vectors, idx.sqnorms, q_ext, qj, k=k + 1, kb=kb,
            tq=512, tn=1024, cls=cls, metric=metric, keep2=keep2, n=n,
            blockmax=blockmax)

    plan.update(layout=layout, kb=kb, keep2=keep2, batch=batch, cls=cls,
                budget=budget)
    return idx, search_at, plan


def _knn_device_sweep(base_dev: torch.Tensor, k: int, metric: int, *,
                      blockmax: bool = False, flush_every: int = 64,
                      hbm_bytes: float | None = None, layout: str = "ext",
                      plan_out: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Self-kNN of a device-resident base: (cand (n, k), dists (n, k)) as
    numpy, self matches removed, the (n, k+1) results copied to the host in
    groups of ``flush_every`` batches. The reference composition that the
    fused ``_sweep_select_level0`` is held to. ``plan_out`` receives the
    sweep's plan."""
    idx, search_at, plan = _sweep_index(base_dev, k, metric, blockmax=blockmax,
                                        hbm_bytes=hbm_bytes, layout=layout)
    if plan_out is not None:
        plan_out.update(plan)
    batch, n = plan["batch"], int(idx.n)
    out_i = np.empty((n, k + 1), np.int32)
    out_d = np.empty((n, k + 1), np.float32)
    buf: list = []

    def flush():
        for lo_, (dd_, ii_) in buf:
            out_d[lo_:lo_ + dd_.shape[0]] = dd_.cpu().numpy()
            out_i[lo_:lo_ + ii_.shape[0]] = ii_.cpu().numpy()
        buf.clear()

    for lo in range(0, n, batch):
        buf.append((lo, search_at(lo)))
        if len(buf) >= flush_every:
            flush()
    flush()
    return _drop_self_sorted(out_i, out_d, k)


def _sweep_select_level0(base_dev: torch.Tensor, vsel: torch.Tensor,
                         ssel: torch.Tensor, k: int, m_out: int, metric: int, *,
                         blockmax: bool = False, flush_every: int = 32,
                         hbm_bytes: float | None = None, layout: str = "ext",
                         plan_out: dict | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Layer 0's kNN and diversity select, fused on the device: per batch,
    the sweep's exact top k+1, the self match dropped, ``select_heuristic``
    to m_out; only the (n, m_out) selection (ids and distances) comes to the
    host. Equal to ``_knn_device_sweep`` followed by ``_device_select``.
    ``plan_out`` receives the sweep's plan."""
    idx, search_at, plan = _sweep_index(base_dev, k, metric, blockmax=blockmax,
                                        fused=True, hbm_bytes=hbm_bytes,
                                        layout=layout)
    if plan_out is not None:
        plan_out.update(plan)
    n, d = int(idx.n), int(idx.dim)
    batch = plan["batch"]
    sb = _select_rows(batch, k, d)
    out_i = np.empty((n, m_out), np.int32)
    out_d = np.empty((n, m_out), np.float32)
    buf: list = []

    def flush():
        for lo_, (si_, sd_) in buf:
            out_i[lo_:lo_ + si_.shape[0]] = si_.cpu().numpy()
            out_d[lo_:lo_ + sd_.shape[0]] = sd_.cpu().numpy()
        buf.clear()

    for lo in range(0, n, batch):
        dd, ii = search_at(lo)
        ci, cd = _drop_self_dev(ii, dd, lo, k=k)
        for slo in range(0, ci.shape[0], sb):
            sel, _, sd = _select_batch(vsel, ssel, ci[slo:slo + sb],
                                       cd[slo:slo + sb], M_out=m_out,
                                       metric=metric, with_dists=True)
            buf.append((lo + slo, (sel, sd)))
            if len(buf) >= flush_every:
                flush()
    flush()
    return out_i, out_d


def _reverse_merge(fwd_sel: np.ndarray, fwd_d: np.ndarray, ids: np.ndarray,
                   cap_c: int, *, native_merge: bool = True
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The reverse-edge merge: the native stage (``native.reverse_merge``,
    which raises when it cannot be built), or with ``native_merge=False``
    its numpy twin, bit-identical to it."""
    if native_merge:
        return native.reverse_merge(fwd_sel, fwd_d, ids, cap_c)
    return _reverse_merge_np(fwd_sel, fwd_d, ids, cap_c)


def _reverse_merge_np(
    fwd_sel: np.ndarray,  # (n, M) selected forward edges (global ids)
    fwd_d: np.ndarray,  # (n, M) their distances
    ids: np.ndarray,  # (n,) global ids of these nodes
    cap_c: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Each vertex's candidates: its forward edges and its incoming ones
    (ranked by (dist, src), at most cap_c granted), deduplicated and sorted
    by (dist, id), -1 pads last. Returns (cand (n, cap_c) global ids,
    dists)."""
    n, M = fwd_sel.shape
    row_of = np.full(int(ids.max()) + 2, -1, np.int64)
    row_of[ids] = np.arange(n)
    # edge list (u -> v): reverse candidate for v is u at the same distance
    src = np.repeat(ids, M)
    dst = fwd_sel.reshape(-1)
    dists = fwd_d.reshape(-1)
    ok = dst >= 0
    src, dst, dists = src[ok], dst[ok], dists[ok]
    rows = row_of[dst]
    order = np.lexsort((src, dists, rows))
    rows, src, dists = rows[order], src[order], dists[order]
    first = np.concatenate([[True], rows[1:] != rows[:-1]])
    gstart = np.maximum.accumulate(np.where(first, np.arange(len(rows)), 0))
    rank = np.arange(len(rows)) - gstart
    # assemble (n, cap_c + M): forward first, then incoming by rank
    cand = np.full((n, cap_c + M), -1, np.int32)
    cd = np.full((n, cap_c + M), np.inf, np.float32)
    cand[:, :M] = fwd_sel
    cd[:, :M] = fwd_d
    keep = rank < cap_c
    cand[rows[keep], M + rank[keep]] = src[keep]
    cd[rows[keep], M + rank[keep]] = dists[keep]
    # dedup (a forward edge may come back as an incoming one), sort by (dist, id)
    order = np.lexsort((np.where(cand < 0, 2**31 - 1, cand), cd), axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    cd = np.take_along_axis(cd, order, axis=1)
    dup = np.zeros_like(cand, dtype=bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = np.where(dup, -1, cand)
    cd = np.where(dup, np.inf, cd)
    order = np.lexsort((np.where(cand < 0, 2**31 - 1, cand), cd), axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    cd = np.take_along_axis(cd, order, axis=1)
    return cand[:, :cap_c], cd[:, :cap_c]


def _promote_components(neighbors0: np.ndarray, levels: np.ndarray) -> None:
    """Raise to level 1 the lowest id of every layer-0 component (weakly
    connected) that holds no upper vertex, so that descent reaches it: a
    pure kNN graph falls apart on well-separated clusters."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n = neighbors0.shape[0]
    flat = neighbors0.reshape(-1)
    ok = flat >= 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(ok.reshape(n, -1).sum(axis=1), out=indptr[1:])
    adj = csr_matrix((np.ones(int(indptr[-1]), np.int8),
                      flat[ok].astype(np.int64), indptr), shape=(n, n))
    n_comp, comp = connected_components(adj, directed=True, connection="weak")
    covered = np.zeros(n_comp, bool)
    covered[comp[levels >= 1]] = True
    lowest = np.full(n_comp, n, np.int64)
    np.minimum.at(lowest, comp, np.arange(n))
    reps = lowest[~covered]
    levels[reps] = np.maximum(levels[reps], 1)


def _load_stage(stage_path: str, key: dict):
    """(neighbors0, levels) of a stage file whose key matches, else None:
    a file of other parameters, or one that cannot be read, is ignored."""
    try:
        z = np.load(stage_path)
        if all(int(z[k] if k in z else 0) == v for k, v in key.items()):
            return z["neighbors0"], z["levels"]
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        pass
    return None


def fast_build_graph(
    vectors: np.ndarray,
    params: HNSWParams | None = None,
    *,
    level_cap: int = 12,
    blockmax: bool = False,
    mesh=None,
    base_dev: torch.Tensor | None = None,
    stage_path: str | None = None,
    pool: int = 0,
    device: torch.device | str | None = None,
    hbm_bytes: float | None = None,
    layout: str = "ext",
    host_select: bool = False,
    timings: dict | None = None,
) -> GraphSoA:
    """A GraphSoA built at scan speed (see the module docstring), on
    ``device``, the CUDA card unless another is given; a ``base_dev`` tensor
    (the rows, resident) fixes the device and moves layer 0 to the fused
    device sweep (``host_select`` keeps the sweep but selects from its
    host table instead).

    ``pool``: the candidate width fed to the select (k, the exact
    neighbours a node gets), the ef_construction analogue; 0 keeps k =
    2 * M, and pool = ef_construction is the JAX package's
    construction-quality parity setting. ``stage_path``: after layer 0 and
    the promotion, (neighbors0, levels) are saved there (an .npz that either
    package reads), keyed on (n, d, M, M0, metric, pool); a rebuild pointed
    at a matching file skips layer 0. ``hbm_bytes`` and ``layout`` steer the
    sweep's plan (``_sweep_index``). Given a ``timings`` dict, the build
    fills it: "levels", each level's stage seconds (layer 0 first;
    "knn_select" where the sweep and the select are fused), "plan", the
    level-0 sweep's memory plan and knobs, and the seconds of "components"
    (the promotion), "upper_levels" and the "total"."""
    if mesh is not None:
        raise NotImplementedError("the sharded build (mesh=) is not ported "
                                  "yet: ROADMAP A8c")
    if base_dev is not None:
        dev = base_dev.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"base_dev is on {dev}, not on {device}")
    else:
        dev = resolve_device(device)
    params = params or HNSWParams()
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    metric = params.metric_id
    M, M0 = params.M_max, params.M_max0
    rec = timings if timings is not None else {}
    rec.update(levels=[], plan={})
    t_start = time.perf_counter()
    if base_dev is not None:
        vsel = base_dev.to(torch.float32)
        ssel = (squared_norms(vsel) if metric == METRIC_L2
                else torch.zeros(n, dtype=torch.float32, device=dev))
    else:
        sqn = ((vectors * vectors).sum(-1).astype(np.float32)
               if metric == METRIC_L2 else np.zeros(n, np.float32))
        vsel = torch.from_numpy(vectors).to(dev)
        ssel = torch.from_numpy(sqn).to(dev)

    levels = np.minimum(draw_levels(n, params), level_cap)
    levels[0] = max(levels[0], levels.max())  # a deterministic top at node 0

    def build_level(ids: np.ndarray, m_out: int, cap: int) -> np.ndarray:
        """The (len(ids), cap) adjacency (global ids) of one level."""
        k = min(max(2 * m_out, pool), len(ids) - 1)
        if k <= 0:
            return np.full((len(ids), cap), -1, np.int32)
        times = {"n": len(ids)}
        t0 = time.perf_counter()
        if base_dev is not None and len(ids) == n and not host_select:
            sel, sel_d = _sweep_select_level0(
                base_dev, vsel, ssel, k, m_out, metric, blockmax=blockmax,
                hbm_bytes=hbm_bytes, layout=layout, plan_out=rec["plan"])
            times["knn_select"] = time.perf_counter() - t0
        else:
            if base_dev is not None and len(ids) == n:
                cand, cd = _knn_device_sweep(base_dev, k, metric,
                                             blockmax=blockmax,
                                             hbm_bytes=hbm_bytes, layout=layout,
                                             plan_out=rec["plan"])
            else:
                cand, cd = _knn_candidates(vectors, ids, k, metric, blockmax, dev)
            width = max(2 * m_out, pool)
            if cand.shape[1] < width:  # one candidate width at every level
                pad = width - cand.shape[1]
                cand = np.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
                cd = np.pad(cd, ((0, 0), (0, pad)), constant_values=np.inf)
            t1 = time.perf_counter()
            times["knn"] = t1 - t0
            sel, _, sel_d = _device_select(vsel, ssel, cand, cd, m_out, metric,
                                           with_dists=True)
            times["select"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        merged, md = _reverse_merge(sel, sel_d, ids, cap + m_out)
        t3 = time.perf_counter()
        out, _ = _device_select(vsel, ssel, merged, md, cap, metric)
        times["reverse_merge"] = t3 - t2
        times["select2"] = time.perf_counter() - t3
        rec["levels"].append(times)
        return out

    key = {"n": n, "d": d, "M": M, "M0": M0, "metric": metric, "pool": pool}
    staged = (_load_stage(stage_path, key)
              if stage_path and os.path.exists(stage_path) else None)
    if staged is not None:
        neighbors0, levels = staged
    else:
        neighbors0 = build_level(np.arange(n, dtype=np.int32), M, M0)
        t0 = time.perf_counter()
        _promote_components(neighbors0, levels)
        rec["components"] = time.perf_counter() - t0
        if stage_path:
            os.makedirs(os.path.dirname(stage_path) or ".", exist_ok=True)
            tmp = stage_path + ".tmp.npz"  # np.savez appends .npz itself
            np.savez(tmp, **key, levels=levels, neighbors0=neighbors0)
            os.replace(tmp, stage_path)

    t0 = time.perf_counter()
    top_level = int(levels.max())
    upper_row = np.where(levels > 0, np.cumsum(levels > 0) - 1, -1).astype(np.int32)
    u_cap = max(int(upper_row.max()) + 1, 1)
    upper_neighbors = np.full((u_cap, max(top_level, 1), M), -1, np.int32)
    for lvl in range(1, top_level + 1):
        ids = np.where(levels >= lvl)[0].astype(np.int32)
        upper_neighbors[upper_row[ids], lvl - 1] = build_level(ids, M, M)
    rec["upper_levels"] = time.perf_counter() - t0
    rec["total"] = time.perf_counter() - t_start

    return GraphSoA(
        params=params,
        vectors=vectors,
        levels=levels.astype(np.int32),
        neighbors0=neighbors0,
        upper_row=upper_row,
        upper_neighbors=upper_neighbors,
        entry_point=int(np.where(levels == top_level)[0].min()),
        top_level=top_level,
    )
