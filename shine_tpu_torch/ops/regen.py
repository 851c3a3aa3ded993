"""Row-keyed rows regenerated by id, and their exact f32 distances to
queries: the port of ``shine_tpu/io/device_synth.py:regen_rows`` and of the
scoring inside ``shine_tpu/ops/distance.py:regen_rerank_topk``.

Row ``id`` of a row-keyed base is ``centers[a] + normal(kn, (d,))`` with
``ka, kn = split(fold_in(key, id))`` and ``a = randint(ka, (), 0, nc)``,
divided by its norm (+1e-30) under IP. Nothing of the base is ever stored:
the capacity path's builds stream rows through ``regen_rows``, and its
re-rank scores each candidate's row straight from its id (``regen_score``).

``regen_rows`` and ``regen_score`` launch the hand-written CUDA kernels of
``csrc/regen_rows.cu`` for tensors on a CUDA device, counted in their
``launches``, and run their plain versions (``regen_rows_ref``,
``regen_score_ref``) for tensors on the CPU. Both versions sum over d in
index order, one term at a time, so a query's scores do not depend on its
batch, and the kernel equals its plain version on the card bit for bit.
Against the JAX package the rows agree in their cluster draw exactly and
in their values within a few ulps (``ops/threefry.py``).
"""

from __future__ import annotations

import ctypes

import torch

from shine_tpu_torch.config import METRIC_IP
from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.ops.gather_score import check_tensor


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, one add at a time."""
    s = t[..., 0].clone()
    for j in range(1, t.shape[-1]):
        s = s + t[..., j]
    return s


def _seq_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """<q[b], rows[b, k]> (B, K) summed over d in index order."""
    s = q[:, None, 0] * rows[..., 0]
    for j in range(1, rows.shape[-1]):
        s = s + q[:, None, j] * rows[..., j]
    return s


def regen_rows_ref(key: torch.Tensor, centers: torch.Tensor, ids: torch.Tensor,
                   *, normalize: bool = False) -> torch.Tensor:
    """(m, d) f32 rows of the ids (m,) on the device of ``centers``, in
    plain torch: the JAX package's ``regen_rows`` with the norm summed in
    index order."""
    nc, d = centers.shape
    ids = ids.to(device=centers.device, dtype=torch.int64)
    keys = tf.split(tf.fold_in(key, ids), 2)  # (m, 2, 2): ka, kn
    a = tf.randint(keys[:, 0], (), 0, nc)
    x = centers[a] + tf.normal(keys[:, 1], (d,))
    if normalize:
        x = x / (torch.sqrt(_seq_sum(x * x))[:, None] + 1e-30)
    return x


def regen_score_ref(key: torch.Tensor, centers: torch.Tensor, q: torch.Tensor,
                    cand_ids: torch.Tensor, metric: int) -> torch.Tensor:
    """(B, K) f32 exact distances of the queries q (B, d) to the
    regenerated rows of their candidates cand_ids (B, K), +inf where an id
    is < 0: ||q||^2 - 2<q, v> + ||v||^2 (L2) or 1 - <q, v> (IP), every sum
    over d in index order."""
    B, K = cand_ids.shape
    d = centers.shape[1]
    ip = metric == METRIC_IP
    safe = cand_ids.clamp_min(0).reshape(-1)
    rows = regen_rows_ref(key, centers, safe, normalize=ip).reshape(B, K, d)
    q = q.to(torch.float32)
    dots = _seq_dot(q, rows)
    if ip:
        dist = 1.0 - dots
    else:
        dist = _seq_sum(q * q)[:, None] - 2.0 * dots + _seq_sum(rows * rows)
    return torch.where(cand_ids >= 0, dist, torch.inf)


def _check_source(key: torch.Tensor, centers: torch.Tensor) -> torch.device:
    if torch.as_tensor(key).numel() != 2:
        raise ValueError("a row source's key is two uint32 words")
    dev = centers.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"centers must be on cpu or cuda, not {dev}")
    if centers.dim() != 2 or centers.shape[0] == 0:
        raise ValueError(f"centers must be (nc, d), nc >= 1, got {tuple(centers.shape)}")
    check_tensor("centers", centers, torch.float32, tuple(centers.shape), dev)
    return dev


def regen_rows(key: torch.Tensor, centers: torch.Tensor, ids: torch.Tensor,
               *, normalize: bool = False) -> torch.Tensor:
    """(m, d) f32 rows of the ids (m,) (int32 or int64, in [0, 2^31)),
    regenerated on the device of ``centers`` (nc, d) f32 from ``key`` (two
    uint32 words, an int64 tensor (2,)); normalised to unit norm with
    ``normalize`` (the IP datasets). CUDA centers launch the kernel, counted
    in ``regen_rows.launches``; CPU centers take ``regen_rows_ref``."""
    dev = _check_source(key, centers)
    if ids.dim() != 1:
        raise ValueError(f"ids must be (m,), got {tuple(ids.shape)}")
    if ids.dtype == torch.int64 and ids.numel() and int(ids.max()) >= 2**31:
        raise ValueError("row ids must be below 2^31: the kernel takes int32 ids")
    if dev.type == "cpu":
        return regen_rows_ref(key, centers, ids, normalize=normalize)
    nc, d = centers.shape
    ids32 = ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((ids32.shape[0], d), dtype=torch.float32, device=dev)
    if ids32.shape[0] == 0:
        return out
    k0, k1 = tf.key_words(torch.as_tensor(key))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shine_regen_rows(
            ctypes.c_uint32(k0), ctypes.c_uint32(k1), centers.data_ptr(), nc, d,
            ids32.data_ptr(), ids32.shape[0], int(normalize), out.data_ptr(),
            stream)
    _build.check(rc, "regen_rows")
    regen_rows.launches += 1
    return out


def regen_score(key: torch.Tensor, centers: torch.Tensor, q: torch.Tensor,
                cand_ids: torch.Tensor, metric: int) -> torch.Tensor:
    """(B, K) f32 exact distances of the queries ``q`` (B, d) f32 to their
    candidates' rows, regenerated from ``cand_ids`` (B, K) int32 (-1 pad:
    +inf); see ``regen_score_ref``. CUDA tensors launch the kernel, counted
    in ``regen_score.launches``; CPU tensors take the plain version."""
    dev = _check_source(key, centers)
    nc, d = centers.shape
    if cand_ids.dim() != 2:
        raise ValueError(f"cand_ids must be (B, K), got {tuple(cand_ids.shape)}")
    B, K = cand_ids.shape
    check_tensor("q", q, torch.float32, (B, d), dev)
    check_tensor("cand_ids", cand_ids, torch.int32, (B, K), dev)
    if dev.type == "cpu":
        return regen_score_ref(key, centers, q, cand_ids, metric)
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return out
    k0, k1 = tf.key_words(torch.as_tensor(key))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shine_regen_score(
            ctypes.c_uint32(k0), ctypes.c_uint32(k1), centers.data_ptr(), nc, d,
            q.data_ptr(), cand_ids.data_ptr(), B, K, int(metric == METRIC_IP),
            out.data_ptr(), stream)
    _build.check(rc, "regen_score")
    regen_score.launches += 1
    return out


regen_rows.launches = 0
regen_score.launches = 0


def make_rowfn(row_source, base_dev: torch.Tensor | None, metric: int):
    """Row provider: global ids (m,) -> (m, d) f32 rows, regenerated from
    ``row_source`` = (key, centers) (unit rows under IP, as the row-keyed
    datasets hold them) or read from the resident ``base_dev``."""
    if row_source is not None:
        key, centers = row_source

        def regen(ids: torch.Tensor) -> torch.Tensor:
            return regen_rows(key, centers, ids, normalize=metric == METRIC_IP)
        return regen
    if base_dev is None:
        raise ValueError("need row_source or base_dev")

    def rowfn(ids: torch.Tensor) -> torch.Tensor:
        return base_dev[ids.long()].to(torch.float32)
    return rowfn
