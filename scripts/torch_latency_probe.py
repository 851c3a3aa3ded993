#!/usr/bin/env python
"""Low-batch latency on one card: the port of the JAX package's
``scripts/latency_probe.py`` (per-dispatch latency at batch 1-512, HNSW
against the fused scan), with ``bench.py``'s low-batch p50/p99 beside it.

The scan reads the whole table a call whatever the batch, so its latency is
about flat in B; HNSW touches ~ef * M rows a query and pays one launch a
layer-0 step, so the batch where one passes the other is the graph family's
niche, if it has one on this card.

The set is bench's: ``synthetic_dataset(200,000, 128, 10,000 queries,
seed=7)``, its exact top-11 computed on the device. The graph is a native
build at M=16, efc=200, stored at ``index_path(cache_dir, name, params)``
and loaded from there when present. For each batch B of 1, 8, 64, 512 on
the first B queries: ``HNSWIndex.search`` at ef=64, frontier 8,
``batch_size=B``, and ``FastFlatIndex.search`` with ``tq = min(512, max(128,
B))`` (the JAX probe's; the batch is padded up to ``tq``), each the best of 5
calls after a warm-up, with recall@10 (the JAX probe's keys ``engine``,
``batch``, ``ms``, ``qps``, ``recall10``) and the kernels' launches in one
call. At B 1 and 64 the record also holds ``p50_ms`` and ``p99_ms`` of 40
calls after two warm-ups by ``bench.py``'s index rule
(``utils/meter.py:p50_p99``) and, on a card, one call's profile (device
time by kernel, busy share). Times are host walls on the synchronised
clock (``utils/timing.py:sync_clock``).

    python scripts/torch_latency_probe.py                  # on the card
    python scripts/torch_latency_probe.py --device cpu --out build/lp.jsonl

The second runs the same sizes on the CPU (the native build and the exact
truth take minutes); a smaller set goes through ``run(Config(n=..., d=...,
nq=...), ...)``, as the tests do. Every record is printed and appended as
one JSON line to ``results/torch_latency_probe.jsonl`` (``--out``), with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.config import HNSWParams, SearchParams  # noqa: E402
from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.graph.soa import build_graph  # noqa: E402
from shine_tpu_torch.io import (  # noqa: E402
    index_path,
    load_dataset,
    load_graph,
    recall_at_k,
    save_graph,
    synthetic_dataset,
)
from shine_tpu_torch.models.flat import FastFlatIndex  # noqa: E402
from shine_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from shine_tpu_torch.ops.distance import exact_knn  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    Recorder,
    card_line,
    latency_walls,
    launches,
    p50_p99,
    profile_once,
    reset_launches,
)
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

OUT = os.path.join(ROOT, "results", "torch_latency_probe.jsonl")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
SEED, GT_K = 7, 11  # bench's set
PARAMS = HNSWParams(M=16, ef_construction=200)
SEARCH = SearchParams(k=10, ef=64, frontier=8)
REPS = 5  # the best of, after a warm-up (the JAX probe's)
TAIL_BATCHES, TAIL_REPS, TAIL_WARMUP = (1, 64), 40, 2  # bench.py's p50/p99


@dataclasses.dataclass
class Config:
    n: int = 200_000
    d: int = 128
    nq: int = 10_000
    batches: tuple = (1, 8, 64, 512)
    data_path: str | None = None  # a saved set in place of the synthetic one
    graph_path: str | None = None  # a saved graph in place of index_path's


def dataset(cfg: Config, dev: torch.device):
    """The probe's set: a saved one (``data_path``), or bench's synthetic one
    with its exact top-``GT_K`` from ``dev``."""
    if cfg.data_path:
        return load_dataset(cfg.data_path)
    ds = synthetic_dataset(n=cfg.n, dim=cfg.d, num_queries=cfg.nq, seed=SEED,
                           compute_gt=False)
    gt, _ = exact_knn(torch.from_numpy(ds.base).to(dev),
                      torch.from_numpy(ds.queries).to(dev), GT_K)
    ds.ground_truth = gt.cpu().numpy()
    return ds


def graph_for(cfg: Config, ds, emit):
    """The graph at ``graph_path``, or at ``index_path`` (built natively and
    stored there when absent)."""
    path = cfg.graph_path or index_path(CACHE_DIR, ds.name, PARAMS)
    if os.path.exists(path):
        return load_graph(path)
    t0 = sync_clock()
    graph = build_graph(ds.base, PARAMS)
    emit({"stage": "build", "n": ds.n, "M": PARAMS.M, "efc": PARAMS.ef_construction,
          "seconds": sync_clock() - t0, "path": os.path.relpath(path, ROOT)})
    save_graph(graph, path)
    return graph


def probe(engine: str, call, B: int, gt, dev: torch.device) -> dict:
    """One engine at one batch: recall@10 and the launches of one call,
    the best of ``REPS`` walls after a warm-up, and at ``TAIL_BATCHES`` the
    p50/p99 of ``TAIL_REPS`` walls."""
    reset_launches()
    ids, _ = call()
    rec = {"stage": "probe", "engine": engine, "batch": B,
           "recall10": recall_at_k(ids, gt, 10), "launches": launches()}
    walls = latency_walls(call, dev, reps=REPS, warmup=1)
    best = min(walls) / 1e3
    rec.update(ms=best * 1e3, qps=B / best)
    if B in TAIL_BATCHES:
        rec["p50_ms"], rec["p99_ms"] = p50_p99(latency_walls(
            call, dev, reps=TAIL_REPS, warmup=TAIL_WARMUP))
        if dev.type == "cuda":  # where one call's device time goes
            rec["profile"] = profile_once(call)
    return rec


def run(cfg: Config, dev: torch.device, out: str) -> list[dict]:
    """Every batch for both engines; returns the records."""
    record = Recorder(out, {"device": str(dev), "card": card_line(dev)})
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    ds = dataset(cfg, dev)
    graph = graph_for(cfg, ds, emit)
    hnsw = HNSWIndex(graph, device=dev)
    fast = FastFlatIndex(ds.base, device=dev)
    emit({"stage": "set", "n": ds.n, "d": ds.dim, "nq": len(ds.queries),
          "dataset": ds.name, "M": graph.params.M, "efc": graph.params.ef_construction,
          "ef": SEARCH.ef, "frontier": SEARCH.frontier})
    for B in cfg.batches:
        q, gt = ds.queries[:B], ds.ground_truth[:B]
        emit({**probe("hnsw", lambda: hnsw.search(q, SEARCH, batch_size=B), B, gt, dev),
              "steps": hnsw.last_steps})
        tq = min(512, max(128, B))
        emit({**probe("fastflat", lambda: fast.search(
            q, 10, batch_size=B, tq=tq, with_dists=False), B, gt, dev), "tq": tq})
    return recs


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    return run(Config(), resolve_device(args.device), args.out)


if __name__ == "__main__":
    main()
