"""The numpy brute-force k-NN oracle and recall@k, as in
``shine_tpu/io/recall.py``."""

from __future__ import annotations

import numpy as np

from shine_tpu_torch.config import METRIC_IP, metric_id


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
