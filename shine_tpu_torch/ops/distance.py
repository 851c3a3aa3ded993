"""Distance helpers of the port, and its fp32 precision lock.

Every product whose result ranks rows (the dense-entry sweep, the
squared norms, the brute-force ground truth, the re-ranks) must run in
full fp32. On a
CUDA card PyTorch runs an fp32 matmul in TF32 (about three decimal
digits) once ``torch.backends.cuda.matmul.allow_tf32`` is set or
``torch.set_float32_matmul_precision`` is lowered from "highest"; at
>= 1M rows that noise exceeds the gaps between true neighbours and
silently corrupts rankings (the JAX package's device ground-truth
incident, ``shine_tpu/ops/distance.py:19-38``). The port never changes
those flags: ``check_precision`` raises if a caller has.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.config import METRIC_IP, METRIC_L2, metric_id
from shine_tpu_torch.ops.beam import dist_id_key


def check_precision() -> None:
    """Raise unless fp32 matmuls run in full fp32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: ranking "
            "products must run in full fp32"
        )
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            f"torch.get_float32_matmul_precision() is {prec!r}: ranking "
            "products must run at 'highest'"
        )


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in full fp32 (a (B, d), b (N, d) -> (B, N))."""
    check_precision()
    return a.to(torch.float32) @ b.to(torch.float32).T


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Exact f32 squared norms over the last axis."""
    check_precision()
    x = x.to(torch.float32)
    return (x * x).sum(dim=-1)


_ONE_HOT_CELLS = 1 << 25  # (rows x clusters) f32 cells of one one-hot slice


def cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums (k, d) f32, counts (k,) f32) of the rows of ``x`` by cluster
    ``assign`` (n,), summed in an order that is the same on every run: a
    one-hot product in full fp32 over slices of rows, the slices added in
    row order. ``index_add_``'s float atomics on a card add in another order
    on each run, and one flipped argmin changes every later Lloyd step. The
    counts are integer, exact."""
    check_precision()
    x = x.to(torch.float32)
    a = assign.to(torch.int64)
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    lane = torch.arange(k, device=x.device)
    rows = max(1, _ONE_HOT_CELLS // max(k, 1))
    for lo in range(0, x.shape[0], rows):
        one_hot = (a[lo:lo + rows, None] == lane[None, :]).to(torch.float32)
        sums += one_hot.T @ x[lo:lo + rows]
    counts = torch.bincount(a, minlength=k).to(torch.float32)
    return sums, counts


def pairwise_distance(
    queries: torch.Tensor,  # (B, d)
    points: torch.Tensor,  # (N, d)
    metric: int = METRIC_L2,
    *,
    points_sqnorm: torch.Tensor | None = None,
) -> torch.Tensor:
    """The full (B, N) f32 distance tile: squared L2, or 1 - <q, p>."""
    q = queries.to(torch.float32)
    p = points.to(torch.float32)
    dots = matmul_nt(q, p)
    if metric == METRIC_IP:
        return 1.0 - dots
    pn = points_sqnorm if points_sqnorm is not None else squared_norms(p)
    return squared_norms(q)[:, None] - 2.0 * dots + pn[None, :]


def exact_knn(
    base: torch.Tensor,  # (N, d) f32
    queries: torch.Tensor,  # (B, d) f32
    k: int,
    *,
    metric: str | int = "l2",
    chunk: int = 32_768,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by chunked fp32 products: (ids (B, k) int32, dists
    (B, k) f32), ascending by (dist, id) like the reference heap. L2 is
    squared; IP distance is 1 - <q, v>."""
    mid = metric_id(metric)
    q = queries.to(torch.float32)
    n = base.shape[0]
    k = min(k, n)
    B = q.shape[0]
    dev = q.device
    best_key = torch.empty((B, 0), dtype=torch.int64, device=dev)
    best_d = torch.empty((B, 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((B, 0), dtype=torch.int64, device=dev)
    qn = squared_norms(q)[:, None]
    for lo in range(0, n, chunk):
        blk = base[lo:lo + chunk].to(torch.float32)
        dots = matmul_nt(q, blk)
        if mid == METRIC_IP:
            d = 1.0 - dots
        else:
            d = qn - 2.0 * dots + squared_norms(blk)[None, :]
        idx = torch.arange(lo, lo + blk.shape[0], device=dev).expand(B, -1)
        all_d = torch.cat([best_d, d], 1)
        all_i = torch.cat([best_i, idx], 1)
        all_key = torch.cat([best_key, dist_id_key(d, idx)], 1)
        # the keys are unique, so topk has no ties to break
        best_key, sel = torch.topk(all_key, k, dim=1, largest=False, sorted=True)
        best_d = torch.gather(all_d, 1, sel)
        best_i = torch.gather(all_i, 1, sel)
    return best_i.to(torch.int32), best_d


def candidate_distance(
    queries: torch.Tensor,  # (B, d)
    cand_vecs: torch.Tensor,  # (B, K, d) gathered candidate rows
    metric: int = METRIC_L2,
    *,
    cand_sqnorm: torch.Tensor | None = None,  # (B, K)
) -> torch.Tensor:
    """(B, K) f32 distances of each query to its own K gathered rows:
    ||q||^2 - 2<q, v> + ||v||^2 (L2; the stored norms when given) or
    1 - <q, v> (IP)."""
    check_precision()
    q = queries.to(torch.float32)
    c = cand_vecs.to(torch.float32)
    dots = torch.einsum("bd,bkd->bk", q, c)
    if metric == METRIC_IP:
        return 1.0 - dots
    cn = cand_sqnorm if cand_sqnorm is not None else squared_norms(c)
    return squared_norms(q)[:, None] - 2.0 * dots + cn


def _sort_keep(d: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """(d, ids) sorted by (dist, id), -1 ids last among equal dists, cut
    to k: ``lax.sort`` on (d, key_i) with two keys."""
    _, order = torch.sort(dist_id_key(d, cand_ids), dim=-1)
    return (torch.gather(d, -1, order)[..., :k],
            torch.gather(cand_ids, -1, order)[..., :k])


def _l2_or_ip(dots: torch.Tensor, q: torch.Tensor, metric: int,
              row_sq: torch.Tensor | None,
              qn: torch.Tensor | None = None) -> torch.Tensor:
    if metric == METRIC_IP:
        return 1.0 - dots
    if qn is None:
        qn = (q * q).sum(dim=-1)  # per query: a rank-invariant offset
    if row_sq is None:  # ``dots`` already holds 2<q, v> - ||v||^2
        return qn[..., None] - dots
    return qn[..., None] - 2.0 * dots + row_sq


def pair_dots(table: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, K) f32 <q[b], table[ids[b, k]]> of f32 queries (B, d) and the
    rows of an f32 or bf16 table (N, d), the ids in range. K1's
    ``gather_score`` (``csrc/gather_score.cu``, its plain twin on the CPU)
    sums each (query, row) pair in one fixed order on the card, so a
    query's products do not depend on its batch (a batched cuBLAS product
    picks its kernel by the batch's size: ROADMAP C11)."""
    from shine_tpu_torch.ops.gather_score import gather_score

    B = q.shape[0]
    zero = torch.zeros(B, dtype=torch.float32, device=q.device)
    return gather_score(table.contiguous(), q.to(torch.float32).contiguous(), zero,
                        ids.to(torch.int32).contiguous(), l2=False)


def query_sqnorms(q: torch.Tensor) -> torch.Tensor:
    """(B,) ||q||^2 of f32 queries, each in one fixed order on the card
    (``pair_dots`` of each query with itself)."""
    ids = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
    q = q.to(torch.float32).contiguous()
    return pair_dots(q, q, ids)[:, 0]


def rerank_topk(
    vectors: torch.Tensor,  # (N, d) f32
    sqnorms: torch.Tensor,  # (N,) f32
    queries: torch.Tensor,  # (..., d) f32
    cand_ids: torch.Tensor,  # (..., K) int32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank of K candidates down to k: (dists (..., k), ids
    (..., k)) ascending by (dist, id); -1 candidates score +inf. The
    products and ||q||^2 come from ``pair_dots`` and ``query_sqnorms``, so
    on the card a query's result does not depend on its batch."""
    check_precision()
    q = queries.to(torch.float32)
    safe = cand_ids.clamp_min(0).long()
    q2 = q.reshape(-1, q.shape[-1])
    dots = pair_dots(vectors, q2, safe.reshape(q2.shape[0], -1)).reshape(safe.shape)
    qn = None if metric == METRIC_IP else query_sqnorms(q2).reshape(q.shape[:-1])
    d = _l2_or_ip(dots, q, metric, sqnorms[safe], qn)
    d = torch.where(cand_ids >= 0, d, torch.inf)
    return _sort_keep(d, cand_ids, k)


def regen_rerank_topk(
    key: torch.Tensor,  # (2,) the row-keyed base's key
    centers: torch.Tensor,  # (nc, d) f32 mixture centres
    queries: torch.Tensor,  # (..., d) f32
    cand_ids: torch.Tensor,  # (..., K) int32 global row ids, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank with no resident base: each candidate's row is
    regenerated from its id and scored against its query
    (``ops/regen.py:regen_score``, a kernel on the card), then (dists
    (..., k), ids (..., k)) ascending by (dist, id); -1 candidates score
    +inf. The sums run over d in index order, so a query's result does not
    depend on its batch."""
    from shine_tpu_torch.ops.regen import regen_score

    q = queries.to(torch.float32)
    lead = cand_ids.shape[:-1]
    cand2 = cand_ids.reshape(-1, cand_ids.shape[-1]).to(torch.int32).contiguous()
    d = regen_score(key, centers, q.reshape(-1, q.shape[-1]).contiguous(), cand2,
                    metric)
    d = d.reshape(lead + (cand_ids.shape[-1],))
    return _sort_keep(d, cand_ids, k)


def _ext_scores(ext: torch.Tensor, q_ext: torch.Tensor,
                cand_ids: torch.Tensor) -> torch.Tensor:
    """<q_ext, ext[id]> of each candidate: bf16 operands, f32 sums."""
    check_precision()
    rows = ext[cand_ids.clamp_min(0).long()].to(torch.float32)  # (..., K, dp)
    qe = q_ext.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("...d,...kd->...k", qe, rows)


def rerank_topk_ext(
    ext: torch.Tensor,  # (N_pad, dp) bf16 packed score table
    queries: torch.Tensor,  # (..., d) f32
    cand_ids: torch.Tensor,  # (..., K) int32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank from the packed bf16 table when no f32 rows are kept:
    distance = ||q||^2 - score (L2) or 1 - score (IP). Its precision is
    the bf16 rows' (~0.4% relative), as the scan's."""
    from shine_tpu_torch.ops.scan import pack_ext_query

    q = queries.to(torch.float32)
    qe = pack_ext_query(q.reshape(-1, q.shape[-1]), ext.shape[1])
    qe = qe.reshape(q.shape[:-1] + (ext.shape[1],))
    d = _l2_or_ip(_ext_scores(ext, qe, cand_ids), q, metric, None)
    d = torch.where(cand_ids >= 0, d, torch.inf)
    return _sort_keep(d, cand_ids, k)


def score_trim(
    vals: torch.Tensor,  # (..., K) f32 scan scores, larger is nearer
    cand_ids: torch.Tensor,  # (..., K) int32, -1 pad
    pre: int,
) -> torch.Tensor:
    """Trim candidates to the best ``pre`` by the scores the scan already
    returned: (score descending, id ascending), -1 pads last."""
    sd = torch.where(cand_ids >= 0, -vals.to(torch.float32), torch.inf)
    return _sort_keep(sd, cand_ids, pre)[1]


def prerank_trim_ext(
    ext: torch.Tensor,  # (N_pad, dp) bf16 packed score table
    q_ext: torch.Tensor,  # (B, dp) packed queries
    cand_ids: torch.Tensor,  # (B, K) int32, -1 pad
    pre: int,
) -> torch.Tensor:
    """Trim candidates to the best ``pre`` by their packed-table scores,
    re-read from ``ext``; ties as ``score_trim``."""
    sd = torch.where(cand_ids >= 0, -_ext_scores(ext, q_ext, cand_ids),
                     torch.inf)
    return _sort_keep(sd, cand_ids, pre)[1]


def _split_scores(comp: torch.Tensor, aux: torch.Tensor, q: torch.Tensor,
                  cand_ids: torch.Tensor) -> torch.Tensor:
    """scl[id] * <q, comp[id]> + nrm[id] of each candidate, in full f32."""
    check_precision()
    safe = cand_ids.clamp_min(0).long()
    rows = comp[safe][..., :q.shape[-1]].to(torch.float32)  # (..., K, d)
    dots = torch.einsum("...d,...kd->...k", q, rows)
    return aux[1][safe] * dots + aux[0][safe]


def rerank_topk_split(
    comp: torch.Tensor,  # (N_pad, dpc) bf16 or int8 component table
    aux: torch.Tensor,  # (2, N_pad) f32: nrm, scl
    queries: torch.Tensor,  # (..., d) f32
    cand_ids: torch.Tensor,  # (..., K) int32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank from the split tables when no f32 rows are kept: distance =
    ||q||^2 - score (L2) or 1 - score (IP). Its precision is the stored
    components' (bf16 ~0.4%, int8 ~s/127 a row)."""
    q = queries.to(torch.float32)
    d = _l2_or_ip(_split_scores(comp, aux, q, cand_ids), q, metric, None)
    d = torch.where(cand_ids >= 0, d, torch.inf)
    return _sort_keep(d, cand_ids, k)


def prerank_trim_split(
    comp: torch.Tensor,  # (N_pad, dpc) bf16 or int8 component table
    aux: torch.Tensor,  # (2, N_pad) f32: nrm, scl
    queries: torch.Tensor,  # (B, d) f32
    cand_ids: torch.Tensor,  # (B, K) int32, -1 pad
    pre: int,
) -> torch.Tensor:
    """Trim candidates to the best ``pre`` by their split-table scores,
    re-read from ``comp`` and ``aux``; ties as ``score_trim``."""
    q = queries.to(torch.float32)
    sd = torch.where(cand_ids >= 0, -_split_scores(comp, aux, q, cand_ids),
                     torch.inf)
    return _sort_keep(sd, cand_ids, pre)[1]
