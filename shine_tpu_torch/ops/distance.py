"""Distance helpers of the port, and its fp32 precision lock.

Every product whose result ranks rows (the dense-entry sweep, the
squared norms, the brute-force ground truth) must run in full fp32. On a
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

from shine_tpu.config import METRIC_IP, metric_id
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
