"""The clustering helpers of the IVF family that the routed build needs: the
port of ``_capacity_assign_host``, ``_spatial_order_centroids``,
``_lloyd_chunked``, ``_lloyd_balance_refine`` and ``_nearest_r_chunk`` in
``shine_tpu/models/ivf.py``. ``IVFIndex`` and its search are not ported yet.

The capacity assignment is numpy, as in the JAX package, and gives the same
result on the same inputs. The k-means runs in full fp32 on the device of
its points; its sums and argmins may differ from XLA's by ulps, so it is
held to the JAX package by tolerance, not bit for bit. The random initial
centres come from a ``torch.Generator`` seeded with ``seed`` on the CPU
(``_draw_init_ids``): the same on the CPU and on the card, not the JAX
package's ``jax.random`` draw.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.ops.beam import smallest_positions
from shine_tpu_torch.ops.distance import (
    cluster_sums,
    matmul_nt,
    pairwise_distance,
    squared_norms,
)


def _capacity_assign_host(
    choice: np.ndarray,  # (n, R) i32 — per-row nearest clusters, best first
    choice_d: np.ndarray,  # (n, R) f32
    num_clusters: int,
    cap,  # int, or (num_clusters,) per-cluster room
    v32: np.ndarray | None = None,  # only for the rare overflow fallback
    cents: np.ndarray | None = None,
    *,
    defer_residue: bool = False,
) -> np.ndarray:
    """Nearest-first capacity-bounded assignment (host, vectorized).

    Points take their rank-r choice in (distance, cluster)-sorted order
    while the cluster has room; overflow spills to rank r+1. The residue
    (no top-R choice had room) goes to the nearest open cluster, or, with
    ``defer_residue``, stays unassigned (-1) for the caller to place."""
    n, R = choice.shape
    assign = np.full(n, -1, dtype=np.int64)
    if np.ndim(cap) == 0:
        room = np.full(num_clusters, cap, dtype=np.int64)
    else:
        room = np.asarray(cap, dtype=np.int64).copy()
    for r in range(R):
        un = np.where(assign < 0)[0]
        if len(un) == 0:
            break
        c_r = choice[un, r]
        order = np.lexsort((choice_d[un, r], c_r))
        un, c_r = un[order], c_r[order]
        # rank within cluster group
        first = np.concatenate([[True], c_r[1:] != c_r[:-1]])
        group_start = np.maximum.accumulate(np.where(first, np.arange(len(c_r)), 0))
        rank = np.arange(len(c_r)) - group_start
        ok = rank < room[c_r]
        assign[un[ok]] = c_r[ok]
        np.subtract.at(room, c_r[ok], 1)
    if defer_residue:
        return assign
    # final fallback: any cluster with room, nearest-first by centroid dist
    un = np.where(assign < 0)[0]
    if len(un):
        if v32 is not None and cents is not None and len(un) <= 65536:
            open_cs = np.where(room > 0)[0]
            dtile = pairwise_distance(torch.from_numpy(v32[un]),
                                      torch.from_numpy(cents[open_cs])).numpy()
            pref = np.argsort(dtile, axis=1, kind="stable")
            for i, qi in enumerate(un):
                for c in open_cs[pref[i]]:
                    if room[c] > 0:
                        assign[qi] = c
                        room[c] -= 1
                        break
        else:
            # no vectors at hand: round-robin the open slots
            open_slots = np.repeat(
                np.arange(num_clusters), np.maximum(room, 0)
            )
            assign[un] = open_slots[: len(un)]
    assert (assign >= 0).all()
    return assign


def _spatial_order_centroids(cents: np.ndarray, seed: int) -> np.ndarray:
    """Permutation that relabels clusters so that spatially near centroids
    get adjacent ids: a coarse k-means over the centroids (on the CPU)
    gives the macro order; within a macro group, order by distance to the
    group's mean. Without it, routed tile unions collapse."""
    from shine_tpu_torch.parallel.placement import _lloyd

    C = cents.shape[0]
    k = max(1, min(C // 8, 256))
    if k <= 1:
        return np.arange(C)
    cents_t = torch.from_numpy(np.ascontiguousarray(cents, dtype=np.float32))
    coarse, _ = _lloyd(cents_t, k=k, iters=15, seed=seed)
    d2 = pairwise_distance(cents_t, coarse).numpy()
    g = d2.argmin(axis=1)
    return np.lexsort((d2[np.arange(C), g], g))


def _draw_init_ids(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct seeded row ids in [0, n): the initial centres."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k]


def _lloyd_chunked(points: torch.Tensor, *, k: int, iters: int, seed: int,
                   chunk: int = 8192) -> torch.Tensor:
    """Lloyd iterations that never hold the (n, k) distance tile: each
    chunk's (chunk, k) scores live for one step; the centroid sums are
    ``cluster_sums`` of the step's assignment, the same on every run.
    Random-row init. n must be a multiple of ``chunk``. Returns (k, d) f32
    centroids."""
    n, d = points.shape
    xs = points.to(torch.float32)
    cents = xs[_draw_init_ids(n, k, seed).to(xs.device)]
    for _ in range(iters):
        csq = squared_norms(cents)
        assign = torch.cat([
            torch.argmin(csq[None, :] - 2.0 * matmul_nt(xs[lo:lo + chunk], cents),
                         dim=1)
            for lo in range(0, n, chunk)])
        sums, counts = cluster_sums(xs, assign, k)
        cents = torch.where(counts[:, None] > 0.5,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    return cents


def _lloyd_balance_refine(points: torch.Tensor, cents: torch.Tensor, *,
                          k: int, rounds: int = 3, R: int = 8,
                          chunk: int = 8192) -> torch.Tensor:
    """Capacity-aware refinement of Lloyd centroids: each round
    capacity-assigns the points (cap = ceil(n/k) a cluster, nearest-first
    over their top-R choices) and recomputes the centroids from that
    assignment, so that cells which would overflow pull their centroid
    into the dense region."""
    n = points.shape[0]
    cap_t = -(-n // k)
    xs = points.to(torch.float32)
    Rr = min(R, k)
    for _ in range(rounds):
        csq = squared_norms(cents)
        parts = [_nearest_r_chunk(xs[lo:lo + chunk], cents, csq, R=Rr)
                 for lo in range(0, n, chunk)]
        cho = torch.cat([p[0] for p in parts]).cpu().numpy()
        cho_d = torch.cat([p[1] for p in parts]).cpu().numpy()
        assign = torch.from_numpy(_capacity_assign_host(cho, cho_d, k, cap_t))
        assign = assign.to(xs.device)
        sums, counts = cluster_sums(xs, assign, k)
        cents = torch.where(counts[:, None] > 0.5,
                            sums / counts.clamp_min(1.0)[:, None], cents)
    return cents


def _nearest_r_chunk(x: torch.Tensor, cents: torch.Tensor, csq: torch.Tensor,
                     *, R: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The R nearest centroids of each row, exactly, with their true
    squared L2 distances (the capacity sort compares them across rows):
    (ids (m, R) int32, dists (m, R) f32), nearest first. The JAX package
    takes ``approx_max_k`` from 4096 centroids on a TPU; the port is exact
    at every C."""
    xf = x.to(torch.float32)
    dd = (xf * xf).sum(dim=-1, keepdim=True) - 2.0 * matmul_nt(xf, cents) + csq[None, :]
    idx = smallest_positions(dd, R)
    return idx.to(torch.int32), torch.gather(dd, 1, idx)
