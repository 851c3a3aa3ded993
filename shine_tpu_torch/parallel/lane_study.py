"""The owned-lane study of the cluster-sharded routed split, on which both
mesh studies stand (``scripts/torch_exp_routed_sharded.py`` and
``scripts/torch_exp_skew_capacity_mesh.py``, the ports of the JAX package's
``exp_routed_sharded.py`` and ``exp_skew_capacity_mesh.py``, which draw the
same set).

The set is drawn by the port's threefry (bit for bit with ``jax.random``):
rows regenerated by id from ``key = PRNGKey(21)`` and 32 centres
``normal(PRNGKey(22), (32, D)) * 4``; ``nq`` queries at rows
``default_rng(23).integers(0, n)`` plus 0.3 * a normal of the same
generator. The build is the direct sharded one on ``S`` shards,
``build_routed_split_sharded(n, D, mesh, row_source, cap_target=1024,
cls=256, train_size=65,536, seed=24, queries=...)``; a search is one pass at
probes 16, shared 32, tile 32, kk 64, batch 256, no spill, at ``P_loc``
owned lanes a shard.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.ops.regen import regen_rows
from shine_tpu_torch.parallel.mesh import shard_mesh
from shine_tpu_torch.parallel.routed_sharded import build_routed_split_sharded
from shine_tpu_torch.utils.meter import launches, reset_launches
from shine_tpu_torch.utils.timing import sync_clock

ROUTE = dict(p=16, P=32, T=32)  # probes, shared clusters, tile
D, S, BATCH = 32, 8, 256
BUILD = dict(cap_target=1024, cls=256, train_size=65_536, seed=24)


def study_set(n: int, nq: int, dev: torch.device):
    """The row source ((key, centres) on ``dev``) and its ``nq`` queries
    near rows drawn by ``default_rng(23)`` (numpy f32)."""
    key = tf.prng_key(21)
    centers = (tf.normal(tf.prng_key(22), (32, D)) * 4.0).to(dev)
    rng = np.random.default_rng(23)
    ids = torch.from_numpy(rng.integers(0, n, nq).astype(np.int32)).to(dev)
    anchors = regen_rows(key, centers, ids).cpu().numpy()
    queries = anchors + rng.normal(size=(nq, D)).astype(np.float32) * 0.3
    return (key, centers), queries


def build(n: int, dev: torch.device, queries: np.ndarray, row_source) -> tuple:
    """The direct sharded build of ``n`` rows on ``S`` shards stacked on
    ``dev``: (index, exact top-10 of ``queries``, its build record)."""
    mesh = shard_mesh(S, device=dev)
    t0 = sync_clock(dev)
    idx, gt = build_routed_split_sharded(n, D, mesh, row_source=row_source, **BUILD,
                                         queries=queries,
                                         log=lambda m: print(m, flush=True))
    return idx, gt, {"stage": "build", "n": n, "d": D, "S": S, "C": idx.C,
                     "cap": idx.cap, "seconds": sync_clock(dev) - t0}


def serve(idx, queries: np.ndarray, gt, P_loc: int, dev: torch.device) -> dict:
    """One search at ``P_loc`` owned lanes a shard: the counters, recall@10,
    the kernels' launches and the pass's wall."""
    reset_launches()
    t0 = sync_clock(dev)
    ids, _ = idx.search(queries, 10, probes=ROUTE["p"], shared=ROUTE["P"],
                        tile=ROUTE["T"], shared_local=P_loc, kk=64, batch_size=BATCH,
                        fallback=0)
    seconds = sync_clock(dev) - t0
    return {"lanes_used": idx.last_lanes, "overflow": idx.last_overflow,
            "coverage": idx.last_coverage, "recall10": recall_at_k(ids, gt, 10),
            "launches": launches(), "seconds": seconds}
