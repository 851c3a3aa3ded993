"""The numpy brute-force k-NN oracle, recall@k and the distance-tolerance
recalls, as in ``shine_tpu/io/recall.py``."""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_IP, METRIC_L2, metric_id
from shine_tpu_torch.ops.regen import make_rowfn


def brute_force_knn(
    base: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    metric: str | int = "l2",
    chunk: int = 65536,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by chunked numpy products: (ids (q, k) int32, dists
    (q, k) float32). L2 is squared; IP distance is 1 - <a, b>. Ties break
    by ascending id, like the reference's heap."""
    mid = metric_id(metric)
    q = queries.astype(np.float32)
    nq = q.shape[0]
    n = base.shape[0]
    k = min(k, n)
    best_d = np.full((nq, k), np.inf, dtype=np.float32)
    best_i = np.full((nq, k), -1, dtype=np.int64)
    qn = (q * q).sum(axis=1, keepdims=True)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        blk = base[lo:hi].astype(np.float32)
        dots = q @ blk.T
        if mid == METRIC_IP:
            d = 1.0 - dots
        else:
            bn = (blk * blk).sum(axis=1)
            d = qn - 2.0 * dots + bn[None, :]
        ids = np.arange(lo, hi, dtype=np.int64)[None, :].repeat(nq, axis=0)
        all_d = np.concatenate([best_d, d], axis=1)
        all_i = np.concatenate([best_i, ids], axis=1)
        # top-k in (dist, id) order
        part = np.argpartition(all_d, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(all_d, part, axis=1)
        pi = np.take_along_axis(all_i, part, axis=1)
        order = np.lexsort((pi, pd), axis=1)
        best_d = np.take_along_axis(pd, order, axis=1)
        best_i = np.take_along_axis(pi, order, axis=1)
    return best_i.astype(np.int32), best_d


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Mean |found[:k] ∩ gt[:k]| / k over the queries both arrays hold."""
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    nq = min(found.shape[0], gt.shape[0])
    if nq == 0:
        return 0.0
    found, gt = found[:nq].astype(np.int64), gt[:nq].astype(np.int64)
    hits = 0
    chunk = 65536
    for lo in range(0, nq, chunk):
        hi = min(lo + chunk, nq)
        m = found[lo:hi, :, None] == gt[lo:hi, None, :]
        hits += int(m.any(axis=2).sum())
    return hits / (nq * k)


def _l2_dists(rowfn, q: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    """Exact f32 squared L2 distances (b, k) of each query to the rows
    ``rowfn`` gives for its ids (b, k); +inf where an id is < 0."""
    flat = ids.clamp_min(0).reshape(-1)
    v = rowfn(flat).reshape(ids.shape + (q.shape[1],)).to(torch.float32)
    dd = ((v - q[:, None, :]) ** 2).sum(dim=-1)
    return torch.where(ids >= 0, dd, torch.inf).cpu().numpy()


def _eps_hits(rowfn, device, found, gt, queries, k, rtol, batch) -> float:
    nq = min(found.shape[0], gt.shape[0], len(queries))
    ok = 0
    for lo in range(0, nq, batch):
        hi = min(lo + batch, nq)
        q = torch.from_numpy(np.asarray(queries[lo:hi], np.float32)).to(device)
        df = _l2_dists(rowfn, q, torch.from_numpy(found[lo:hi].astype(np.int64)).to(device))
        dg = _l2_dists(rowfn, q, torch.from_numpy(gt[lo:hi].astype(np.int64)).to(device))
        thresh = np.sort(dg, axis=1)[:, k - 1] * (1.0 + rtol) + 1e-12
        ok += int((df <= thresh[:, None]).sum())
    return ok / (nq * k)


def recall_at_k_eps(
    found_ids: np.ndarray,
    queries,
    base_dev: torch.Tensor,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
) -> float:
    """Distance-tolerance recall: the share of returned rows whose exact
    squared L2 distance is within (1 + rtol) of the true k-th neighbour's.
    Id recall counts near-ties that no scan can tell apart as misses (at
    10M+ synthetic rows the 10th and 11th neighbours sit closer than bf16
    precision); this does not. Distances are exact f32 on the device of
    the resident base ``base_dev``."""
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    return _eps_hits(make_rowfn(None, base_dev, METRIC_L2), base_dev.device, found,
                     gt, queries, k, rtol, batch)


def recall_at_k_eps_regen(
    found_ids: np.ndarray,
    queries,
    row_source,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
) -> float:
    """``recall_at_k_eps`` for a row-keyed base: the rows are regenerated
    by id from ``row_source`` = (key, centers) (``ops/regen.py``, on the
    device of ``centers``) instead of gathered from a resident base. L2
    only, as in the JAX package."""
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    return _eps_hits(make_rowfn(row_source, None, METRIC_L2), row_source[1].device,
                     found, gt, queries, k, rtol, batch)


def margin_mask(
    queries,
    base_dev: torch.Tensor | None,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
    row_source=None,
) -> np.ndarray:
    """Bool (nq,): the queries whose top-k boundary is real, the exact
    (k+1)-th distance above (1 + rtol) times the k-th. ``gt_ids`` needs k+1
    columns. Id recall over these queries alone (``recall_at_k(found[m],
    gt[m], k)``) shows the search without the near-tie artefact, and ``1 -
    mask.mean()`` measures the artefact. Exact f32 squared L2 distances
    against the resident ``base_dev`` or, with ``row_source`` = (key,
    centers), against rows regenerated by id (``base_dev`` ignored)."""
    gt = np.asarray(gt_ids)[:, : k + 1]
    if gt.shape[1] != k + 1:
        raise ValueError("margin_mask needs gt_ids with k+1 columns")
    nq = min(gt.shape[0], len(queries))
    rowfn = make_rowfn(row_source, base_dev, METRIC_L2)
    device = (row_source[1] if row_source is not None else base_dev).device
    out = np.empty(nq, bool)
    for lo in range(0, nq, batch):
        hi = min(lo + batch, nq)
        q = torch.from_numpy(np.asarray(queries[lo:hi], np.float32)).to(device)
        dg = np.sort(_l2_dists(rowfn, q, torch.from_numpy(
            gt[lo:hi].astype(np.int64)).to(device)), axis=1)
        out[lo:hi] = dg[:, k] > dg[:, k - 1] * (1.0 + rtol) + 1e-12
    return out


def numpy_subset_gt(
    queries: np.ndarray, base: np.ndarray, k: int = 10, *,
    chunk: int = 131072, metric: str | int = "l2",
) -> np.ndarray:
    """Exact top-k ids in numpy alone, the scorer's independent witness: a
    chunked running top-32 in (dist, id) order. L2 ranks by ||v||^2 -
    2<q, v> (the query's norm is a per-query constant)."""
    m = metric_id(metric)
    q = queries.astype(np.float32)
    ne = len(q)
    keep = max(32, k)
    bn = (base.astype(np.float32) ** 2).sum(axis=1)
    best_d = np.full((ne, keep), np.inf, np.float32)
    best_i = np.full((ne, keep), -1, np.int64)
    for lo in range(0, len(base), chunk):
        hi = min(lo + chunk, len(base))
        dots = q @ base[lo:hi].astype(np.float32).T
        dd = 1.0 - dots if m == METRIC_IP else -2.0 * dots + bn[lo:hi]
        ids = np.arange(lo, hi, dtype=np.int64)[None, :].repeat(ne, axis=0)
        ad = np.concatenate([best_d, dd], axis=1)
        ai = np.concatenate([best_i, ids], axis=1)
        part = np.argpartition(ad, keep - 1, axis=1)[:, :keep]
        pd = np.take_along_axis(ad, part, axis=1)
        pi = np.take_along_axis(ai, part, axis=1)
        order = np.lexsort((pi, pd), axis=1)
        best_d = np.take_along_axis(pd, order, axis=1)
        best_i = np.take_along_axis(pi, order, axis=1)
    return best_i[:, :k]


def gt_crosscheck(
    queries: np.ndarray, base: np.ndarray, gt_dev: np.ndarray,
    k: int = 10, *, n_eval: int = 256, chunk: int = 131072,
    metric: str | int = "l2",
) -> float:
    """Overlap of a device-computed ground truth with ``numpy_subset_gt``
    on the first ``n_eval`` queries: 1.0 certifies the scorer, and below
    ~0.999 on synthetic data the ground truth itself is corrupt."""
    ne = min(n_eval, len(queries), len(gt_dev))
    gt_np = numpy_subset_gt(queries[:ne], base, k, chunk=chunk, metric=metric)
    return recall_at_k(np.asarray(gt_dev)[:ne], gt_np, k)
