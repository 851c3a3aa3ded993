"""One step of every sharded path at tiny sizes: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python -c "from shine_tpu_torch.parallel import dryrun_mesh; dryrun_mesh(8)"

runs on a mesh of n shards over the visible cards, stacked on a single
one (``device="cpu"``: on the CPU, where the kernels' plain twins run)
the same steps at the same sizes as the JAX package's dry run, with its
assertions:

  1. one sharded insert round (the batch scattered, the plans gathered,
     the replicated apply; ``models/build.py``);
  2. the sharded scan-speed build, served back over the same mesh;
  3. ``ShardedIndex``: the dense exchange, the compact one (ids as the
     dense one's), bf16 rows (ids as the single device's bf16 index's);
  4. ``ShardedFlatIndex`` and ``ShardedFastFlatIndex``;
  5. the row-keyed capacity ext and split tables over the mesh, re-ranked
     from rows regenerated by id;
  6. ``ShardedRoutedSplitIndex.from_single`` of a routed build of
     ``shards=n``.

It raises on the first assertion that fails and returns the seconds of
each step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.parallel.mesh import shard_mesh

# the JAX dry run's tiny graph: 2048 x 64, M=8, ef_construction=64
TINY = dict(n=2048, dim=64, num_queries=256, seed=3)
TINY_BUILD = HNSWParams(M=8, ef_construction=64)
ROUND_BUILD = HNSWParams(M=8, ef_construction=32)
SHARD_KNN_MIN = 64  # the sharded fastbuild's kNN stage runs at 512 rows


def dryrun_mesh(n_shards: int, device: torch.device | str | None = None) -> dict:
    """Run every step on a mesh of ``n_shards`` shards on ``device`` (the
    CUDA card unless another is given); returns {step: seconds}."""
    from shine_tpu_torch.graph import build_graph
    from shine_tpu_torch.io import recall_at_k, synthetic_dataset
    from shine_tpu_torch.io.device_synth import (
        device_rowkeyed_ext_dataset,
        device_rowkeyed_split_dataset,
    )
    from shine_tpu_torch.models import fastbuild
    from shine_tpu_torch.models.build import (
        init_build_state,
        make_sharded_insert_round,
        replicate_build_state,
    )
    from shine_tpu_torch.models.hnsw import HNSWIndex
    from shine_tpu_torch.models.routed_split import build_routed_split
    from shine_tpu_torch.ops import threefry as tf
    from shine_tpu_torch.parallel import (
        ShardedFastFlatIndex,
        ShardedFlatIndex,
        ShardedIndex,
        ShardedRoutedSplitIndex,
        ShardedSplitFlatIndex,
    )

    S = n_shards
    mesh = shard_mesh(S, device=device)
    dev = mesh.devices[0]
    seconds: dict = {}
    clock = [time.perf_counter()]

    def step(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    ds = synthetic_dataset(**TINY, compute_gt=False)
    graph = build_graph(ds.base, TINY_BUILD, threads=4)
    nq = 16 * S
    sp = SearchParams(k=5, ef=32)
    step("tiny_graph")

    # 1. one sharded insert round
    B = 8 * S
    st = init_build_state(ds.base[:512], ROUND_BUILD, device=dev)
    states = replicate_build_state(st, mesh)
    run_round = make_sharded_insert_round(mesh, ef=32, frontier=4, max_add=16,
                                          metric=0, B_up_loc=8)
    run_round(states, np.arange(1, 1 + B, dtype=np.int32))
    for s in states:
        assert s.count == 1 + B, s.count
        assert int(s.degree0[1:1 + B].min()) >= 0
    step("insert_round")

    # 2. the sharded fastbuild, served back over the mesh
    old_min = fastbuild.SHARD_KNN_MIN
    fastbuild.SHARD_KNN_MIN = SHARD_KNN_MIN
    try:
        g_m = fastbuild.fast_build_graph(ds.base[:512], ROUND_BUILD, mesh=mesh)
    finally:
        fastbuild.SHARD_KNN_MIN = old_min
    rids, rdists = ShardedIndex(g_m, mesh).search(ds.queries[:nq], sp, batch_size=nq)
    assert rids.shape == (nq, 5)
    assert (rids >= 0).all() and np.isfinite(rdists).all()
    step("fastbuild")

    # 3. ShardedIndex: dense, compact, bf16 rows
    index = ShardedIndex(graph, mesh)
    ids, dists = index.search(ds.queries[:nq], sp, batch_size=nq)
    assert ids.shape == (nq, 5)
    assert (ids >= 0).all() and np.isfinite(dists).all()
    cids, _ = index.search(ds.queries[:nq], SearchParams(k=5, ef=32, exchange="compact"),
                           batch_size=nq)
    assert (cids == ids).mean() > 0.99
    assert index.ici_bytes > 0
    bids, bdists = ShardedIndex(graph, mesh, rows="bf16").search(
        ds.queries[:nq], sp, batch_size=nq)
    sids, _ = HNSWIndex(graph, rows="bf16", device=dev).search(ds.queries[:nq], sp,
                                                               batch_size=nq)
    assert (bids == sids).mean() > 0.99
    assert np.isfinite(bdists).all()
    step("sharded_index")

    # 4. the row-sharded exact scan and the class-max scan
    fids, fdists = ShardedFlatIndex(ds.base, mesh).search(ds.queries[:64], 5, chunk=1024)
    assert fids.shape == (64, 5)
    assert (fids >= 0).all() and np.isfinite(fdists).all()
    gids, gdists = ShardedFastFlatIndex(ds.base, mesh).search(
        ds.queries[:128], 5, tq=128, batch_size=128)
    assert gids.shape == (128, 5)
    assert (gids >= 0).all() and np.isfinite(gdists).all()
    step("flat")

    # 5. the row-keyed capacity tables over the mesh
    eds = device_rowkeyed_ext_dataset(n=4096 * S, dim=16, num_queries=64, seed=5,
                                      rchunk=2048, mesh=mesh)
    cap = ShardedFastFlatIndex.from_ext(eds.ext_dev, eds.n, mesh, dim=16,
                                        row_source=eds.row_source)
    kids, kdists = cap.search(eds.queries, 5, tq=64, batch_size=64)
    assert kids.shape == (64, 5)
    assert (kids >= 0).all() and np.isfinite(kdists).all()
    assert recall_at_k(kids, eds.ground_truth, 5) > 0.9
    pids, _ = cap.search(eds.queries, 5, kb=32, tq=64, batch_size=64, prerank=16)
    assert recall_at_k(pids, eds.ground_truth, 5) > 0.9
    sds = device_rowkeyed_split_dataset(n=16384 * S, dim=16, num_queries=64, seed=6,
                                        rchunk=4096, comp_dtype="int8", mesh=mesh)
    scap = ShardedSplitFlatIndex.from_dataset(sds, mesh, dim=16)
    sids, sdists = scap.search(sds.queries, 5, tq=64, batch_size=64)
    assert sids.shape == (64, 5)
    assert (sids >= 0).all() and np.isfinite(sdists).all()
    assert recall_at_k(sids, sds.ground_truth, 5) > 0.9
    step("capacity")

    # 6. the routed split index dealt over the mesh
    key = tf.prng_key(11)
    cents = (tf.normal(tf.prng_key(12), (8, 16)) * 4.0).to(dev)
    ridx = build_routed_split(4096, 16, row_source=(key, cents), cap_target=512,
                              cls=128, train_size=4096, seed=7, shards=S)
    rsh = ShardedRoutedSplitIndex.from_single(ridx, mesh)
    rids, rdists = rsh.search(sds.queries, 5, probes=8, shared=16, tile=32,
                              batch_size=64)
    assert rids.shape[1] == 5
    assert np.isfinite(rdists).all()
    assert rsh.last_coverage is not None and rsh.last_coverage > 0.9
    step("routed")
    return seconds
