"""Fused candidate-row gather and scoring: the port of the Pallas row gather
(``shine_tpu/ops/pallas_gather.py``) together with the scoring that
followed it in ``shine_tpu/models/hnsw.py:_dist_ext``.

``gather_score`` launches the hand-written CUDA kernel
(``csrc/gather_score.cu``) for tensors on a CUDA device and runs its plain
twin ``gather_score_ref`` for tensors on the CPU. There is no other route:
a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops.distance import check_precision, squared_norms

ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def gather_score_ref(
    vectors: torch.Tensor,  # (N, d) f32 | bf16 | int8
    q_ext: torch.Tensor,  # (B, d) f32
    bias: torch.Tensor,  # (B,) f32
    ids: torch.Tensor,  # (B, K) int32, -1 = masked
    *,
    row_scl: torch.Tensor | None = None,  # (N,) f32, int8 rows
    row_nrm: torch.Tensor | None = None,  # (N,) f32, int8 rows under L2
    l2: bool = True,
) -> torch.Tensor:
    """(B, K) distances in plain torch, ``_dist_ext``'s formula: gather,
    einsum, norm, mask. inf where id < 0."""
    check_precision()
    safe = ids.clamp_min(0).to(torch.int64)
    ve = vectors[safe].to(torch.float32)  # (B, K, d)
    dots = torch.einsum("bd,bkd->bk", q_ext, ve)
    if row_scl is not None:  # int8 rows: dequantize after the dot
        dots = dots * row_scl[safe]
        if l2:
            dots = dots + row_nrm[safe]
    elif l2:
        dots = dots + squared_norms(ve)
    return torch.where(ids >= 0, bias[:, None] + dots, torch.inf)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, vectors on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(vectors: torch.Tensor, row_scl: torch.Tensor | None,
               row_nrm: torch.Tensor | None, l2: bool) -> None:
    """Raise unless ``vectors`` is an (N, d) f32|bf16|int8 table on the CPU
    or a card, with ``row_scl`` (and ``row_nrm`` under L2) exactly when it
    is int8, and d small enough for the kernels' shared query row."""
    dev = vectors.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the row table must be on cpu or cuda, not {dev}")
    if vectors.dtype not in ROW_TYPES or vectors.dim() != 2:
        raise TypeError(
            f"vectors must be (N, d) f32|bf16|int8, got {vectors.dtype} "
            f"{tuple(vectors.shape)}"
        )
    N, d = vectors.shape
    check_tensor("vectors", vectors, vectors.dtype, (N, d), dev)
    if vectors.dtype == torch.int8:
        if row_scl is None or (l2 and row_nrm is None):
            raise ValueError("int8 rows need row_scl, and row_nrm under L2")
        check_tensor("row_scl", row_scl, torch.float32, (N,), dev)
        if row_nrm is not None:
            check_tensor("row_nrm", row_nrm, torch.float32, (N,), dev)
    elif row_scl is not None or row_nrm is not None:
        raise ValueError("row_scl/row_nrm belong to int8 rows only")
    if d * 4 > 48 * 1024:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory query row")


def gather_score(
    vectors: torch.Tensor,
    q_ext: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    *,
    row_scl: torch.Tensor | None = None,
    row_nrm: torch.Tensor | None = None,
    l2: bool = True,
) -> torch.Tensor:
    """(B, K) f32 distances of the candidate rows ``vectors[ids]``; see
    ``gather_score_ref`` for the formula. The inputs are checked on either
    device; CPU tensors then take the plain twin, CUDA tensors launch the
    kernel, counted in ``gather_score.launches``."""
    check_rows(vectors, row_scl, row_nrm, l2)
    dev = vectors.device
    N, d = vectors.shape
    B, K = ids.shape
    check_tensor("q_ext", q_ext, torch.float32, (B, d), dev)
    check_tensor("bias", bias, torch.float32, (B,), dev)
    check_tensor("ids", ids, torch.int32, (B, K), dev)
    if dev.type == "cpu":
        return gather_score_ref(vectors, q_ext, bias, ids, row_scl=row_scl,
                                row_nrm=row_nrm, l2=l2)
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shine_gather_score(
            vectors.data_ptr(), ROW_TYPES[vectors.dtype], q_ext.data_ptr(),
            bias.data_ptr(), ids.data_ptr(),
            row_scl.data_ptr() if row_scl is not None else None,
            row_nrm.data_ptr() if row_nrm is not None else None,
            out.data_ptr(), N, B, K, d, int(l2), stream,
        )
    _build.check(rc, "gather_score")
    gather_score.launches += 1
    return out


gather_score.launches = 0
