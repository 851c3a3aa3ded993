"""What the scan-speed graph build (``models/fastbuild.py``) takes from the
JAX package's ``shine_tpu/models/build.py``: the level draw and the
batched diversity select. The batched insert rounds and
``device_build_graph`` of that module are not ported (ROADMAP A7).

``draw_levels`` is numpy, the same draw bit for bit. ``select_heuristic``
is torch on the device of its inputs; its pairwise tile is a full-fp32
product (``check_precision``), so on the same f32 inputs it keeps what the
JAX package keeps wherever the two products agree (always on
integer-valued rows).
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, HNSWParams
from shine_tpu_torch.ops.distance import check_precision


def draw_levels(n: int, params: HNSWParams) -> np.ndarray:
    """Geometric level draw, floor(-log(U) * m_L) (the reference's
    hnsw.hh:48), from numpy's generator seeded with ``params.seed``."""
    rng = np.random.default_rng(params.seed)
    u = rng.random(n)
    return np.floor(-np.log(u) * params.m_L).astype(np.int32)


def select_heuristic(
    cand_ids: torch.Tensor,  # (B, C) sorted by (dist, id) ascending, -1 pad
    cand_dists: torch.Tensor,  # (B, C)
    cand_vecs: torch.Tensor,  # (B, C, d)
    cand_sqnorms: torch.Tensor,  # (B, C)
    M: int,
    metric: int,
    fill: bool = False,
    with_dists: bool = False,
):
    """Diversity selection (the reference's select_heuristic, hnsw.hh:482-522):
    scan the candidates nearest first and keep c iff dist(c, q) <
    dist(c, s) for every kept s, at most M. One (C, C) pairwise tile a row
    feeds the sequential scan.

    ``fill`` tops unfilled slots up with the nearest pruned candidates
    (hnswlib's keepPrunedConnections), as the scan-speed build needs: its
    pools are nearest-only, which the bare heuristic over-prunes.

    Returns (sel_ids (B, M) int32, -1 padded, sel_count (B,) int32); with
    ``with_dists`` also the kept candidates' query distances (B, M), inf
    padded. The kept ids are compacted into M + 1 columns whose last one
    takes every dropped candidate and is cut off: it is never a slot."""
    check_precision()
    B, C = cand_ids.shape
    dev = cand_ids.device
    v = cand_vecs.to(torch.float32)
    dots = torch.bmm(v, v.transpose(1, 2))
    if metric == METRIC_L2:
        sq = cand_sqnorms.to(torch.float32)
        pair = sq[:, :, None] - 2.0 * dots + sq[:, None, :]
    else:
        pair = 1.0 - dots
    dists = cand_dists.to(torch.float32)
    valid = cand_ids >= 0
    kept = torch.zeros((B, C), dtype=torch.bool, device=dev)
    n_kept = torch.zeros(B, dtype=torch.int32, device=dev)
    for c in range(C):
        # closer to some kept candidate than to the query: skip
        closer = (kept & (pair[:, c, :] < dists[:, c, None])).any(dim=1)
        ok = valid[:, c] & ~closer & (n_kept < M)
        kept[:, c] = ok
        n_kept += ok.to(torch.int32)
    if fill:
        pruned = ~kept & valid
        prank = torch.cumsum(pruned.to(torch.int32), dim=1) - 1
        take = pruned & (prank < (M - n_kept)[:, None])
        kept |= take
        n_kept += take.sum(dim=1, dtype=torch.int32)
    slot = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    slot = torch.where(kept, slot, M)  # dropped: the throwaway column M
    sel = torch.full((B, M + 1), -1, dtype=torch.int32, device=dev)
    sel.scatter_(1, slot, cand_ids.to(torch.int32))
    if with_dists:
        sd = torch.full((B, M + 1), torch.inf, dtype=torch.float32, device=dev)
        sd.scatter_(1, slot, dists)
        return sel[:, :M], n_kept, sd[:, :M]
    return sel[:, :M], n_kept
