"""The packed score table of the class-max scan: the port of
``pack_ext_table`` and ``pack_ext_query`` (``shine_tpu/ops/pallas_scan.py``).

Row r of the table is ``[2v | c0 | c1]`` under L2 and ``[v | 0 | 0]``
under IP, in bf16, where ``c0 + c1`` carries -||v||^2 over two bf16
columns (c0 its bf16 rounding, c1 the remainder: one bf16 column alone
quantizes the largest term of the row at ~||v||^2 * 2^-9). A query packs
as ``[q | 1 | 1]``, so ``score = <q_ext, row>`` is 2<q, v> - ||v||^2
(L2) or <q, v> (IP): larger is nearer. Pad rows hold NEG in column d and
never win.

The JAX package pads the width to a multiple of 128 lanes (256 at d=128),
a TPU tiling rule. The port pads it to a multiple of 16, the depth of one
bf16 ``mma`` (144 at d=128): zero columns add nothing to a score, and the
scan does 1.78x less arithmetic at d=128. The first d+2 columns equal the
JAX package's bit for bit; rows stay padded to its 4096-row quantum, so
row ids and pad rows match.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2
from shine_tpu_torch.ops.distance import squared_norms

NEG = -3e38  # the scan's minus infinity, representable in bf16 and f32
QUANTUM = 4096  # table rows are padded to a multiple of this
_PACK_ROWS = 65_536  # rows packed per step on the device


def ext_width(d: int) -> int:
    """Packed width of a d-dimensional table: d + 2 rounded up to 16."""
    return -(-(d + 2) // 16) * 16


def _pack(v: torch.Tensor, t: torch.Tensor | None, metric: int, n_pad: int,
          device: torch.device) -> torch.Tensor:
    """bf16 (n_pad, ext_width(d)) table from f32 rows ``v`` (n, d) and,
    under L2, their -||v||^2 ``t`` (n,), packed in row chunks on
    ``device``."""
    n, d = v.shape
    ext = torch.zeros((n_pad, ext_width(d)), dtype=torch.bfloat16,
                      device=device)
    for lo in range(0, n, _PACK_ROWS):
        hi = min(lo + _PACK_ROWS, n)
        x = v[lo:hi].to(device=device, dtype=torch.float32)
        if metric == METRIC_L2:
            ext[lo:hi, :d] = (2.0 * x).to(torch.bfloat16)
            tt = t[lo:hi].to(device=device, dtype=torch.float32)
            c0 = tt.to(torch.bfloat16)
            ext[lo:hi, d] = c0
            ext[lo:hi, d + 1] = (tt - c0.to(torch.float32)).to(torch.bfloat16)
        else:
            ext[lo:hi, :d] = x.to(torch.bfloat16)
    # NEG rounds to bf16 from f32, as the JAX package's f32 table does
    ext[n:, d] = torch.tensor(NEG, dtype=torch.float32).to(torch.bfloat16)
    return ext


def pack_ext_table(vectors: np.ndarray, metric: int, n_pad: int, *,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The packed bf16 table of host rows, on ``device``. -||v||^2 is the
    numpy f32 row sum, as in the JAX package, so that the norm columns
    match it bit for bit."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    t = torch.from_numpy(-(v * v).sum(-1)) if metric == METRIC_L2 else None
    return _pack(torch.from_numpy(v), t, metric, n_pad, torch.device(device))


def pack_ext_device(v: torch.Tensor, metric: int) -> torch.Tensor:
    """The packed table of rows already on a device, padded with pad rows
    to a multiple of QUANTUM (none when n is one); the norm is the port's
    full-fp32 ``squared_norms``."""
    t = -squared_norms(v) if metric == METRIC_L2 else None
    return _pack(v, t, metric, -(-v.shape[0] // QUANTUM) * QUANTUM, v.device)


def pack_ext_query(q: torch.Tensor, dp: int) -> torch.Tensor:
    """(B, dp) f32 ``[q | 1 | 1 | 0...]``: 1.0 in both norm columns (an IP
    table holds 0 in them for real rows)."""
    B, d = q.shape
    qe = torch.zeros((B, dp), dtype=torch.float32, device=q.device)
    qe[:, :d] = q.to(torch.float32)
    qe[:, d] = 1.0
    if d + 1 < dp:
        qe[:, d + 1] = 1.0
    return qe
