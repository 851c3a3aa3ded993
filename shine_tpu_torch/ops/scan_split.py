"""The split score tables of SplitFlatIndex: the port of the host parts of
``shine_tpu/ops/pallas_scan_split.py``.

A row's score is ``scl[row] * <q, comp[row]> + nrm[row]`` (larger is
nearer). ``comp`` (N_pad, dpc) holds the row in bf16, or in int8 with a
per-row symmetric scale s (v ~ comp * s/127); ``aux`` (2, N_pad) f32
holds nrm in row 0 and scl in row 1:

  - bf16, L2: scl = 2, nrm = -||v_bf16||^2; IP: scl = 1, nrm = 0;
  - int8, L2: scl = 2s/127, nrm = -||v_q||^2; IP: scl = s/127, nrm = 0.

Pad rows hold comp = 0, scl = 1, nrm = NEG, so they score exactly NEG and
never enter a class. Rows are padded to the JAX package's 16384-row
quantum, so row ids, pad rows and class membership match its tables. The
width is padded to a multiple of 16, the depth of one bf16 ``mma``, not to
its 128 lanes: zero columns add nothing to a score (at d=128 both are
128).
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2
from shine_tpu_torch.ops.distance import squared_norms

NEG = -3e38  # the scan's minus infinity
SPLIT_QUANTUM = 16384  # split tables are padded to a multiple of this
COMP_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
_PACK_ROWS = 65_536  # rows packed per step on the device


def comp_width(dim: int) -> int:
    """Component width of a dim-wide table: dim rounded up to 16."""
    return -(-dim // 16) * 16


def _check_dtype(comp_dtype: str) -> None:
    if comp_dtype not in COMP_DTYPES:
        raise ValueError(f"comp_dtype must be 'bf16' or 'int8', got {comp_dtype!r}")


def pack_split_query(q: torch.Tensor, dpc: int) -> torch.Tensor:
    """(B, dpc) bf16 queries, zero-padded to the component width."""
    B, d = q.shape
    out = torch.zeros((B, dpc), dtype=torch.float32, device=q.device)
    out[:, :d] = q.to(torch.float32)
    return out.to(torch.bfloat16)


def pack_split_tables(v: np.ndarray, metric: int, n_pad: int, *,
                      comp_dtype: str = "bf16",
                      device: torch.device | str = "cpu"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(comp (n_pad, dpc), aux (2, n_pad)) of host rows ``v`` (n, d), on
    ``device``. The packing runs in numpy as in the JAX package (f32 row
    sums, ``rint``/``clip`` for int8), so both hold the same tables bit
    for bit."""
    _check_dtype(comp_dtype)
    v = np.ascontiguousarray(v, dtype=np.float32)
    n, d = v.shape
    aux = np.zeros((2, n_pad), np.float32)
    aux[0, n:] = NEG
    aux[1, :] = 1.0
    if comp_dtype == "int8":
        s = np.maximum(np.abs(v).max(axis=1), 1e-30)
        qv = np.clip(np.rint(v * (127.0 / s[:, None])), -127, 127)
        rows = torch.from_numpy(qv.astype(np.int8))
        vq = qv * (s[:, None] / 127.0)
        if metric == METRIC_L2:
            aux[1, :n] = 2.0 * s / 127.0
            aux[0, :n] = -np.sum(vq * vq, axis=1)
        else:
            aux[1, :n] = s / 127.0
    else:
        rows = torch.from_numpy(v).to(torch.bfloat16)
        vb = rows.to(torch.float32).numpy()
        if metric == METRIC_L2:
            aux[1, :n] = 2.0
            aux[0, :n] = -np.sum(vb * vb, axis=1)
    dev = torch.device(device)
    comp = torch.zeros((n_pad, comp_width(d)), dtype=COMP_DTYPES[comp_dtype],
                       device=dev)
    comp[:n, :d] = rows.to(dev)
    return comp, torch.from_numpy(aux).to(dev)


def pack_split_device(v: torch.Tensor, metric: int, *,
                      comp_dtype: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """The split tables of rows already on a device, packed in row chunks
    there, with no pad rows; the norms are the port's full-fp32
    ``squared_norms``."""
    _check_dtype(comp_dtype)
    n, d = v.shape
    dev = v.device
    comp = torch.zeros((n, comp_width(d)), dtype=COMP_DTYPES[comp_dtype],
                       device=dev)
    aux = torch.zeros((2, n), dtype=torch.float32, device=dev)
    for lo in range(0, n, _PACK_ROWS):
        hi = min(lo + _PACK_ROWS, n)
        x = v[lo:hi].to(torch.float32)
        if comp_dtype == "int8":
            s = x.abs().amax(dim=1).clamp_min(1e-30)
            qv = torch.round(x * (127.0 / s[:, None])).clamp(-127, 127)
            comp[lo:hi, :d] = qv.to(torch.int8)
            if metric == METRIC_L2:
                aux[0, lo:hi] = -squared_norms(qv * (s[:, None] / 127.0))
                aux[1, lo:hi] = 2.0 * s / 127.0
            else:
                aux[1, lo:hi] = s / 127.0
        else:
            xb = x.to(torch.bfloat16)
            comp[lo:hi, :d] = xb
            if metric == METRIC_L2:
                aux[0, lo:hi] = -squared_norms(xb)
                aux[1, lo:hi] = 2.0
            else:
                aux[1, lo:hi] = 1.0
    return comp, aux


def pad_split_tables(comp: torch.Tensor, aux: torch.Tensor,
                     n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Append pad rows (comp 0, scl 1, nrm NEG) up to ``n_pad`` rows."""
    pad = n_pad - comp.shape[0]
    if pad <= 0:
        return comp, aux
    comp = torch.cat([comp, comp.new_zeros((pad, comp.shape[1]))])
    pad_aux = torch.tensor([[NEG], [1.0]], dtype=torch.float32,
                           device=aux.device).expand(2, pad)
    return comp, torch.cat([aux, pad_aux], dim=1)
