"""Command-line entry point of the port: ``python -m shine_tpu_torch``.

The counterpart of ``shine_tpu/cli.py`` (``python -m shine_tpu``), with the
same flags, defaults and branches, on one CUDA card:

  --data-path --synthetic N:D --query-suffix --num-queries --zipf --warmup
  --index {hnsw,flat,fastflat,ivf,split,routed,auto} -m --ef-construction
  --ip-dist --seed --store-index --load-index --device-build --fast-build
  -k --ef-search --frontier --probes --ivf-routed --ivf-shared --ivf-tile
  --batch --rows --prerank --no-recall --label

``--device {cuda,cpu}`` (default cuda) is the one flag the port adds: every
index and build runs there, and without a card the run fails unless it
asks for the CPU, where each kernel's plain twin runs. ``--shards N``
serves on a mesh of N shards (``parallel/mesh.py``: shard s on card s
modulo the visible cards, stacked on a single card, or all on the CPU):
``--index hnsw`` (``ShardedIndex``, with ``--cache``, ``--cache-ratio``,
``--adaptive-cache``, ``--routing``, ``--adaptive-routing``,
``--exchange`` and ``--adaptive-slack``), ``flat`` (``ShardedFlatIndex``),
``fastflat`` (``ShardedFastFlatIndex``), ``split``
(``ShardedSplitFlatIndex.from_host``, int8), ``routed``
(``build_routed_split(shards=N)`` dealt by ``ShardedRoutedSplitIndex.
from_single``, the base resident for the re-rank) and ``ivf``
(``ShardedIVFIndex``, with or without ``--ivf-routed``); with one shard
those flags are ignored, as in the JAX command line, and the other
families ignore ``--cache`` and the routing flags. The paths the port does
not have yet make ``main`` exit with status 2 before any data is read,
naming the ROADMAP item they wait for: ``--megabatch`` (A2); ``--shards`` >
1 with auto, ``--device-build`` or ``--fast-build`` (A8c). ``--ivf-routed``
with another family than ivf is ignored, as in the JAX command line.

Output: the run's Statistics document (``utils/stats.py``, the JAX
package's keys plus ``meta.device``, and ``meta.shard_devices`` on a
mesh) as the last line on stdout. Build time
is host wall time with the card synchronised before each clock read; the
kernel library and the native builder are built before the build clock
starts, and the first batch is served once, untimed, before the timed run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from shine_tpu_torch import native
from shine_tpu_torch.config import HNSWParams, SearchParams, auto_index_family
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.graph import build_graph
from shine_tpu_torch.io import (
    load_dataset,
    load_graph,
    recall_at_k,
    save_graph,
    synthetic_dataset,
)
from shine_tpu_torch.io.skew import skewed_workload
from shine_tpu_torch.models.build import device_build_graph
from shine_tpu_torch.models.fastbuild import fast_build_graph
from shine_tpu_torch.models.flat import FastFlatIndex, FlatIndex, SplitFlatIndex
from shine_tpu_torch.models.hnsw import HNSWIndex
from shine_tpu_torch.models.ivf import IVFIndex
from shine_tpu_torch.models.routed_split import build_routed_split
from shine_tpu_torch.ops import _build as kernels
from shine_tpu_torch.parallel import (
    ShardedFastFlatIndex,
    ShardedFlatIndex,
    ShardedIndex,
    ShardedIVFIndex,
    ShardedRoutedSplitIndex,
    ShardedSplitFlatIndex,
    shard_mesh,
)
from shine_tpu_torch.utils import SearchStats, Statistics, Timing
from shine_tpu_torch.utils.timing import sync_clock

CACHE_RATIO = 0.1  # --cache-ratio's default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shine_tpu_torch")
    src = p.add_argument_group("dataset")
    src.add_argument("--data-path", help="dataset dir (base.fbin, queries/...)")
    src.add_argument("--synthetic", help="N:D synthetic dataset instead of files")
    src.add_argument("--query-suffix", default="query")
    src.add_argument("--num-queries", type=int, default=0, help="cap query count")
    src.add_argument("--zipf", type=float, default=0.0, help="Zipf alpha workload")
    src.add_argument("--warmup", type=int, default=0, help="warmup queries")
    idx = p.add_argument_group("index")
    idx.add_argument(
        "--index",
        choices=("hnsw", "flat", "fastflat", "ivf", "split", "routed",
                 "auto"),
        default="hnsw",
        help="auto picks the scan family by rows per card: fastflat up to "
             "20M, routed up to 64M, int8 split above (the JAX package's "
             "rule, config.auto_index_family; not measured on the card)",
    )
    idx.add_argument("-m", type=int, default=32, help="HNSW M")
    idx.add_argument("--ef-construction", type=int, default=500)
    idx.add_argument("--ip-dist", action="store_true", help="inner-product metric")
    idx.add_argument("--seed", type=int, default=42)
    idx.add_argument("--store-index", help="path to save the built index")
    idx.add_argument("--load-index", help="path to load a prebuilt index")
    idx.add_argument("--device-build", action="store_true",
                     help="build HNSW on the device (batched insert rounds)")
    idx.add_argument("--fast-build", action="store_true",
                     help="build HNSW from the exact kNN sweep (fastbuild)")
    q = p.add_argument_group("query")
    q.add_argument("-k", type=int, default=10)
    q.add_argument("--ef-search", type=int, default=128)
    q.add_argument("--frontier", type=int, default=4)
    q.add_argument("--probes", type=int, default=16,
                   help="ivf/routed: clusters each query wishes for (routed: "
                        "0 = auto)")
    q.add_argument("--ivf-routed", action="store_true",
                   help="ivf: tile-shared probing (search_routed); ignored "
                        "by the other families")
    q.add_argument("--ivf-shared", type=int, default=0,
                   help="clusters granted a tile; 0 = 96 for --ivf-routed, "
                        "the auto rule for routed")
    q.add_argument("--ivf-tile", type=int, default=0,
                   help="queries a tile; 0 = 256 for --ivf-routed, the auto "
                        "rule for routed")
    q.add_argument("--batch", type=int, default=2048)
    q.add_argument(
        "--rows", choices=("f32", "bf16", "int8"), default="f32",
        help="HNSW traversal-row storage (quantized at upload, "
        "models/hnsw.py)",
    )
    q.add_argument("--prerank", type=int, default=0,
                   help="fastflat/split: trim to this many candidates by the "
                        "scan's own scores before the exact re-rank (0 = off)")
    q.add_argument("--megabatch", action="store_true",
                   help="one program over the whole query stream (not "
                        "ported: ROADMAP A2)")
    q.add_argument("--exchange", choices=("dense", "compact"),
                   default="dense", help="sharded-HNSW exchange pattern "
                   "(compact: bucketed all_to_all owner exchange)")
    q.add_argument("--adaptive-slack", action="store_true",
                   help="compact exchange: probe the bucket-slack ladder on "
                   "live batches, serve at the fewest measured wire bytes")
    q.add_argument("--no-recall", action="store_true")
    run = p.add_argument_group("run")
    run.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where every index and build runs; cpu runs the "
                          "kernels' plain twins")
    run.add_argument("--shards", type=int, default=1,
                     help="shards of the mesh, over the visible cards or on the "
                     "CPU (every family but auto and the hnsw builds: ROADMAP "
                     "A8c)")
    run.add_argument("--cache", action="store_true",
                     help="sharded hnsw: hot-vertex replica")
    run.add_argument("--cache-ratio", type=float, default=CACHE_RATIO,
                     help="the replica's share of the nodes")
    run.add_argument("--adaptive-cache", action="store_true",
                     help="refresh the hot set from live access counts")
    run.add_argument("--routing", action="store_true",
                     help="sharded hnsw: affinity routing")
    run.add_argument("--adaptive-routing", action="store_true",
                     help="cross-batch quota feedback (update_limits analogue)")
    run.add_argument("--label", default="")
    return p


def unported_flags(args: argparse.Namespace) -> list[tuple[str, str]]:
    """(flag, ROADMAP item) of each flag given whose path is not ported."""
    mesh = args.shards > 1
    shards = f"--shards {args.shards}"
    checks = (
        (args.megabatch, "--megabatch", "A2"),
        (mesh and args.index == "auto", f"{shards} --index auto", "A8c"),
        (mesh and args.index == "hnsw" and args.device_build,
         f"{shards} --device-build", "A8c"),
        (mesh and args.index == "hnsw" and args.fast_build,
         f"{shards} --fast-build", "A8c"),
    )
    return [(flag, item) for given, flag, item in checks if given]


def _load_libraries(args, dev) -> None:
    """Build (at first use) and load what the run's path calls, so that
    no compile lands in a timed window: the CUDA kernels on a card (IVF
    calls none), the native builder where the graph is built or merged on
    the host."""
    if dev.type == "cuda" and args.index != "ivf":
        kernels.load()
    if args.index == "hnsw" and not (args.load_index or args.device_build):
        native.load()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    unported = unported_flags(args)
    if unported:
        for flag, item in unported:
            print(f"shine_tpu_torch: {flag} is not ported yet: ROADMAP {item}",
                  file=sys.stderr)
        return 2

    dev = resolve_device(args.device)
    metric = "ip" if args.ip_dist else "l2"
    timing = Timing(dev)

    if args.synthetic:
        n, d = (int(x) for x in args.synthetic.split(":"))
        ds = synthetic_dataset(
            n=n, dim=d, num_queries=max(args.num_queries or 1000, 1),
            metric=metric, seed=args.seed, compute_gt=not args.no_recall,
        )
    elif args.data_path:
        ds = load_dataset(args.data_path, metric=metric, query_suffix=args.query_suffix)
    else:
        print("need --data-path or --synthetic", file=sys.stderr)
        return 2

    queries = ds.queries
    gt = ds.ground_truth  # kept row-aligned with `queries` through reshaping
    if args.num_queries:
        queries = queries[: args.num_queries]
        if gt is not None:
            gt = gt[: args.num_queries]
    warmup_q = None
    if args.zipf > 0 or args.warmup:
        warmup_q, queries, pool_idx = skewed_workload(
            queries, total=len(queries), alpha=args.zipf,
            warmup=args.warmup, seed=args.seed,
        )
        if gt is not None:
            gt = gt[pool_idx]  # ground truth follows the resampled pool rows

    stats = Statistics(
        dataset=ds.name, label=args.label, num_shards=args.shards,
        zipf=args.zipf,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
    params = HNSWParams(
        M=args.m, ef_construction=args.ef_construction, metric=metric,
        seed=args.seed,
    )
    sp = SearchParams(k=args.k, ef=args.ef_search, frontier=args.frontier,
                      exchange=args.exchange,
                      adaptive_slack=args.adaptive_slack)
    stats.set_params(params, sp)
    mesh = None
    if args.shards > 1:
        # shard s on card s % the visible cards (on one card they stack),
        # or every shard on the CPU
        mesh = shard_mesh(args.shards, device=None if dev.type == "cuda" else dev)
        stats.meta["shard_devices"] = mesh.describe()

    if args.index == "auto":
        args.index = auto_index_family(ds.n, args.shards)
        print(f"# --index auto: {ds.n / 1e6:.1f}M rows/card -> {args.index}",
              file=sys.stderr)

    # ---- build / load ----
    _load_libraries(args, dev)
    t0 = sync_clock(dev)
    searcher, index_bytes, index_obj = _build(args, ds, params, sp, dev, mesh,
                                              timing)
    build_s = sync_clock(dev) - t0
    stats.set_build(
        num_vectors=ds.n, build_seconds=build_s, index_bytes=index_bytes
    )

    # ---- warmup ----
    if warmup_q is not None and len(warmup_q):
        with timing.measure("warmup"):
            if hasattr(index_obj, "warm"):
                # a whole warm-up pass heats the access counters and adapts
                # the hot set before the timed run (compute_node.cc:116-131)
                index_obj.warm(warmup_q, sp, batch_size=args.batch)
            else:
                searcher(warmup_q[: args.batch])

    # ---- timed queries ----
    s = SearchStats()
    searcher(queries[: args.batch])  # untimed first batch
    with timing.measure("query"):
        t0 = sync_clock(dev)
        ids = searcher(queries)
        s.add_batch(
            len(queries), hops_sum=0, steps=0, cand_lanes=0, row_bytes=0,
            seconds=sync_clock(dev) - t0,
        )
    if not args.no_recall and gt is not None:
        s.recall = recall_at_k(ids, gt, args.k)
    s.expansions = getattr(index_obj, "last_hops", 0)
    if s.expansions:
        # the traversal's exact counts: expansions, scored lanes, steps; the
        # sharded search keeps the JAX package's hops * M_max0 estimate
        s.distance_computations = (getattr(index_obj, "last_dists", 0)
                                   or s.expansions * params.M_max0)
        s.steps = index_obj.last_steps
        s.hbm_gather_bytes = s.distance_computations * 4 * (ds.dim + 1)
    elif hasattr(index_obj, "cost_counters"):
        # the dense families: costs are analytic in the shapes
        if args.index == "ivf" and args.ivf_routed:
            cc = index_obj.routed_cost_counters(
                len(queries), args.k, probes=args.probes,
                shared=args.ivf_shared or 96, tile=args.ivf_tile or 256,
            )
        else:
            kw = {"batch_size": args.batch}
            if args.index == "ivf":
                kw["probes"] = args.probes
            elif args.index == "routed":
                kw = {"probes": args.probes, "shared": args.ivf_shared,
                      "tile": args.ivf_tile}
            cc = index_obj.cost_counters(len(queries), args.k, **kw)
        s.distance_computations = cc["distance_computations"]
        s.scanned_rows = cc["scanned_rows"]
        s.hbm_gather_bytes = cc["hbm_gather_bytes"]
        s.ici_exchange_bytes = cc["ici_exchange_bytes"]
    if getattr(index_obj, "ici_bytes", 0):
        # the sharded search's own count, both exchange modes
        s.ici_exchange_bytes = int(index_obj.ici_bytes)
    s.cache_hits = getattr(index_obj, "cache_hits", 0)
    s.cache_misses = getattr(index_obj, "cache_misses", 0)
    stats.set_queries(s)
    stats.timings = timing.as_dict()
    print(stats.dumps())
    return 0


def _build(args, ds, params, sp, dev, mesh, timing):
    """Returns (searcher(queries) -> ids, index_size_bytes, index_obj)."""
    if args.index == "flat":
        if mesh is not None:
            idx = ShardedFlatIndex(ds.base, mesh, metric=params.metric)
        else:
            idx = FlatIndex(ds.base, metric=params.metric, device=dev)
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch)[0],
            ds.base.nbytes,
            idx,
        )
    if args.index == "fastflat":
        # the class-max route (K2) on the card and on the CPU alike; the
        # JAX command line's CPU runs take the block-max route instead, but
        # its sharded runs the class-max route too
        if mesh is not None:
            idx = ShardedFastFlatIndex(ds.base, mesh, metric=params.metric)
        else:
            idx = FastFlatIndex(ds.base, metric=params.metric, device=dev)
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch,
                                 prerank=args.prerank)[0],
            ds.base.nbytes,
            idx,
        )
    if args.index == "split":
        # the int8 split capacity layout (136 B a row at d=128); with
        # --shards the tables row-shard over the mesh
        if mesh is not None:
            idx = ShardedSplitFlatIndex.from_host(
                ds.base, mesh, metric=params.metric, comp_dtype="int8",
                seed=args.seed,
            )
            nbytes = sum(c.nbytes + a.nbytes for c, a in zip(idx.comp, idx.aux))
        else:
            idx = SplitFlatIndex(
                ds.base, metric=params.metric, comp_dtype="int8",
                seed=args.seed, device=dev,
            )
            nbytes = idx.comp.nbytes + idx.aux.nbytes
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch,
                                 prerank=args.prerank)[0],
            nbytes,
            idx,
        )
    if args.index == "routed":
        # cluster-pruned serving over the split tables, the base resident
        # for the exact re-rank; --probes/--ivf-shared/--ivf-tile map to
        # (probes, shared, tile), 0 taking the search's auto rules; with
        # --shards the clusters deal round-robin over the mesh and the
        # exact re-rank reads the resident base (base mode)
        base_dev = torch.from_numpy(
            np.ascontiguousarray(ds.base, dtype=np.float32)).to(dev)
        idx = build_routed_split(
            ds.n, ds.dim, base_dev=base_dev, metric=params.metric,
            seed=args.seed, shards=args.shards if mesh is not None else 1,
        )
        nbytes = idx.comp.nbytes + idx.aux_r.nbytes + idx.gid.nbytes
        if mesh is not None:
            idx = ShardedRoutedSplitIndex.from_single(idx, mesh)
        return (
            lambda q: idx.search(
                q, args.k, probes=args.probes, shared=args.ivf_shared,
                tile=args.ivf_tile, batch_size=args.batch,
            )[0],
            nbytes,
            idx,
        )
    if args.index == "ivf":
        if mesh is not None:
            idx = ShardedIVFIndex(ds.base, mesh, metric=params.metric,
                                  seed=args.seed)
        else:
            idx = IVFIndex(ds.base, metric=params.metric, seed=args.seed,
                           device=dev)
        if args.ivf_routed:
            return (
                lambda q: idx.search_routed(
                    q, args.k, probes=args.probes,
                    shared=args.ivf_shared or 96, tile=args.ivf_tile or 256,
                )[0],
                ds.base.nbytes * 2,
                idx,
            )
        return (
            lambda q: idx.search(q, args.k, probes=args.probes,
                                 batch_size=args.batch)[0],
            ds.base.nbytes * 2,
            idx,
        )
    # hnsw
    if args.load_index:
        with timing.measure("load_index_buffer"):
            graph = load_graph(args.load_index)
    elif args.device_build:
        graph = device_build_graph(ds.base, params, device=dev)
    elif args.fast_build:
        # layer 0 is stage-checkpointed next to a stored index, so that a
        # build cut short resumes; the rows go resident, which runs layer 0
        # as the device self-sweep (the class-max route)
        stage = (
            args.store_index + ".stage0.npz" if args.store_index else None
        )
        base_dev = torch.from_numpy(
            np.ascontiguousarray(ds.base, dtype=np.float32)).to(dev)
        graph = fast_build_graph(ds.base, params, base_dev=base_dev,
                                 stage_path=stage)
    else:
        graph = build_graph(ds.base, params)
    if args.store_index:
        with timing.measure("store_index_buffer"):
            save_graph(graph, args.store_index)
    nbytes = sum(
        a.nbytes
        for a in (graph.vectors, graph.levels, graph.neighbors0,
                  graph.upper_row, graph.upper_neighbors)
    )
    if mesh is not None:
        # --cache-ratio of the node count (the reference's cache sizing,
        # compute_node.cc:43-56); int8 rows raise: the sharded rows are
        # f32 or bf16
        cache_cap = int(args.cache_ratio * ds.n) if args.cache else 0
        idx = ShardedIndex(
            graph, mesh, cache_capacity=cache_cap,
            routing="adaptive" if args.adaptive_routing else args.routing,
            adaptive_cache=args.adaptive_cache and cache_cap > 0,
            rows=args.rows,
        )
    else:
        idx = HNSWIndex(graph, rows=args.rows, device=dev)
    return lambda q: idx.search(q, sp, batch_size=args.batch)[0], nbytes, idx


if __name__ == "__main__":
    raise SystemExit(main())
