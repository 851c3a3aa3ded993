"""The block-max scans: K5, the port of ``blockmax_scan``
(``shine_tpu/ops/pallas_scan.py``), and K6, the port of ``blockmax_scan2``
and ``group_rows`` (``shine_tpu/ops/pallas_scan2.py``).

Both score bf16 queries ``q_ext`` (B, dp) against the packed bf16 table
``ext`` (N_pad, dp) of ``ops/scan.py`` (bf16 products, f32 sums) and keep
a few rows a block:

- K5 (``blockmax_scan``, N_pad % 128 == 0): for each 128-row contiguous
  block, the best score and its row (the lowest row winning a tie) and the
  runner-up of the block with the winner's lane masked to exactly NEG, as
  the Pallas kernel masks it: a tied twin of the winner is the runner-up,
  and a block of pad rows gives (NEG, the winner's row). Four (B, N_pad/128)
  outputs in natural layout. This is the JAX package's FastFlat route when
  it interprets on the CPU (``FastFlatIndex(interpret=True)``), which the
  port calls the block-max route.
- K6 (``blockmax_scan2``, N_pad % 4096 == 0): the class-max at cls = 128
  of each 4096-row chunk, restarted at every chunk: column c*128 + p holds
  the best of rows c*4096 + m*128 + p, m = 0..31, and its row, the first
  member winning a tie (member 0 enters whatever it scores). Two
  (B, N_pad/32) outputs. No path of the JAX package calls it.

CPU tensors take the plain twins (``*_ref``, chunked over rows so that
they fit at 1M rows on a card); CUDA tensors launch the hand-written
kernels (K5 the block walk and K6 the chunked walk of
``csrc/classmax2_scan.cu``) or raise. Each wrapper counts its launches in
``<wrapper>.launches``. ``tq`` and ``tn`` are accepted for the JAX
signature and pick no tiling.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops.classmax import _KERNEL_MAX_DP, _check_2d, _check_device
from shine_tpu_torch.ops.distance import matmul_nt
from shine_tpu_torch.ops.scan import NEG

BLK = 128  # K5's rows a block
BLK2 = 32  # K6's members a chunk
COLS = 128  # K6's classes a chunk
TN = BLK2 * COLS  # K6's rows a chunk
_REF_ROWS = 32_768  # rows the twins score a step
_K5_MAX_DP = 1312  # widest table whose 64-query tile fits beside K5's ring


def group_rows(tn: int = TN) -> int:
    """Row quantum K6's table must be padded to."""
    return TN


def _first_max(dd: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Max over ``dim`` and the first index reaching it (int32)."""
    mx = dd.amax(dim=dim, keepdim=True)
    shape = [1] * dd.dim()
    shape[dim] = dd.shape[dim]
    idx = torch.arange(dd.shape[dim], dtype=torch.int32,
                       device=dd.device).view(shape)
    first = torch.where(dd == mx, idx, dd.shape[dim]).amin(dim=dim)
    return mx.squeeze(dim), first.to(torch.int32)


def blockmax_scan_ref(ext: torch.Tensor, q_ext: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
    """Plain twin of ``blockmax_scan``: f32 products over row chunks (a
    bf16 product is exact in f32), each block's best, and its best with the
    winner's lane set to NEG."""
    n_pad = ext.shape[0]
    B = q_ext.shape[0]
    dev = ext.device
    outs = [torch.empty((B, n_pad // BLK), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    qf = q_ext.to(torch.float32)
    for lo in range(0, n_pad, _REF_ROWS):
        hi = min(lo + _REF_ROWS, n_pad)
        dd = matmul_nt(qf, ext[lo:hi]).view(B, -1, BLK)
        m1, a1 = _first_max(dd, 2)
        dd.scatter_(2, a1[..., None].long(), NEG)  # the winner's lane
        m2, a2 = _first_max(dd, 2)
        rows = (lo + torch.arange(0, hi - lo, BLK, dtype=torch.int32,
                                  device=dev))[None, :]
        cols = slice(lo // BLK, hi // BLK)
        outs[0][:, cols], outs[1][:, cols] = m1, rows + a1
        outs[2][:, cols], outs[3][:, cols] = m2, rows + a2
    return tuple(outs)


def blockmax_scan2_ref(ext: torch.Tensor, q_ext: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``blockmax_scan2``: per chunk, the max over the 32
    strided members of each class and the first member reaching it."""
    n_pad = ext.shape[0]
    B = q_ext.shape[0]
    dev = ext.device
    m1 = torch.empty((B, n_pad // BLK2), dtype=torch.float32, device=dev)
    a1 = torch.empty((B, n_pad // BLK2), dtype=torch.int32, device=dev)
    qf = q_ext.to(torch.float32)
    lane = torch.arange(COLS, dtype=torch.int32, device=dev)
    step = max(TN, _REF_ROWS // TN * TN)
    for lo in range(0, n_pad, step):
        hi = min(lo + step, n_pad)
        dd = matmul_nt(qf, ext[lo:hi]).view(B, -1, BLK2, COLS)
        mx, member = _first_max(dd, 2)  # (B, chunks, COLS)
        chunk = torch.arange(lo // TN, hi // TN, dtype=torch.int32, device=dev)
        rows = chunk[None, :, None] * TN + member * COLS + lane
        cols = slice(lo // BLK2, hi // BLK2)
        m1[:, cols] = mx.reshape(B, -1)
        a1[:, cols] = rows.reshape(B, -1)
    return m1, a1


def _check(ext: torch.Tensor, q_ext: torch.Tensor, quantum: int,
           max_dp: int) -> None:
    _check_device(ext)
    _check_2d("ext", ext, (torch.bfloat16,))
    _check_2d("q_ext", q_ext, (torch.bfloat16,))
    if q_ext.device != ext.device:
        raise ValueError(f"q_ext is on {q_ext.device}, ext on {ext.device}")
    n_pad, dp = ext.shape
    if q_ext.shape[1] != dp:
        raise ValueError(f"query width {q_ext.shape[1]} != table width {dp}")
    if n_pad % quantum:
        raise ValueError(f"the table's {n_pad} rows must be a multiple of {quantum}")
    if ext.device.type == "cuda":
        if dp % 16 or dp > max_dp:
            raise ValueError(f"the kernel takes widths that are multiples of 16 "
                             f"up to {max_dp}, got {dp}")
        if n_pad >= 2**31:
            raise ValueError("row ids must fit in int32")
        if ext.data_ptr() % 16 or q_ext.data_ptr() % 16:
            raise ValueError("the kernel's inputs must be 16-byte aligned")


def _launch(wrapper, entry, ext, q_ext, outs) -> tuple[torch.Tensor, ...]:
    """Launch ``entry`` on the card, adding one to ``wrapper.launches``;
    an empty batch launches nothing and counts nothing."""
    if q_ext.shape[0] == 0:
        return outs
    lib = _build.load()
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream(ext.device).cuda_stream
        rc = getattr(lib, entry)(ext.data_ptr(), q_ext.data_ptr(), ext.shape[0],
                                 q_ext.shape[0], ext.shape[1],
                                 *(o.data_ptr() for o in outs), stream)
        _build.check(rc, wrapper.__name__)
        wrapper.launches += 1
    return outs


def blockmax_scan(ext, q_ext, *, tq=256, tn=1024):
    """(max1, arg1, max2, arg2), each (B, N_pad/128): the best two (score,
    row) pairs of each 128-row block, by the Pallas kernel's rule."""
    _check(ext, q_ext, BLK, _K5_MAX_DP)
    if ext.device.type == "cpu":
        return blockmax_scan_ref(ext, q_ext)
    B, nb = q_ext.shape[0], ext.shape[0] // BLK
    outs = tuple(torch.empty((B, nb), dtype=dt, device=ext.device)
                 for dt in (torch.float32, torch.int32) * 2)
    return _launch(blockmax_scan, "shine_blockmax_scan", ext, q_ext, outs)


def blockmax_scan2(ext, q_ext, *, tq=128):
    """(max1 (B, N_pad/32) f32, arg1 (B, N_pad/32) int32): the class-max at
    cls = 128 of each 4096-row chunk."""
    _check(ext, q_ext, TN, _KERNEL_MAX_DP)
    if ext.device.type == "cpu":
        return blockmax_scan2_ref(ext, q_ext)
    B, nb = q_ext.shape[0], ext.shape[0] // BLK2
    outs = (torch.empty((B, nb), dtype=torch.float32, device=ext.device),
            torch.empty((B, nb), dtype=torch.int32, device=ext.device))
    return _launch(blockmax_scan2, "shine_blockmax_scan2", ext, q_ext, outs)


blockmax_scan.launches = 0
blockmax_scan2.launches = 0
