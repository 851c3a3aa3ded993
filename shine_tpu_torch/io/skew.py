"""Zipf-skewed query workloads, as in ``shine_tpu/io/skew.py``: the same
seed draws the same indices in both packages. A workload draws from a
query pool with Zipf(alpha) popularity, with a warm-up split served before
the timed run.
"""

from __future__ import annotations

import numpy as np


def zipf_ranks(n_ranks: int, alpha: float, size: int, seed: int = 0) -> np.ndarray:
    """Sample ``size`` ranks in [0, n_ranks) with P(r) ∝ 1/(r+1)^alpha.
    alpha=0 is uniform."""
    rng = np.random.default_rng(seed)
    if alpha <= 0:
        return rng.integers(0, n_ranks, size=size)
    w = 1.0 / np.power(np.arange(1, n_ranks + 1, dtype=np.float64), alpha)
    p = w / w.sum()
    return rng.choice(n_ranks, size=size, p=p)


def skewed_workload(
    query_pool: np.ndarray,  # (P, d) distinct queries
    total: int,
    alpha: float,
    *,
    warmup: int = 0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(warmup_queries, timed_queries, pool_indices_of_timed). Pool entries
    are ranked by a random permutation, so that popularity does not follow
    the id, and drawn with Zipf(alpha) popularity."""
    P = query_pool.shape[0]
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(P)  # rank -> pool index
    ranks = zipf_ranks(P, alpha, total + warmup, seed=seed)
    idx = perm[ranks]
    w, t = idx[:warmup], idx[warmup:]
    return query_pool[w], query_pool[t], t
