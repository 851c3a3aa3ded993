#!/usr/bin/env python
"""The sharded HNSW's wire cost, 8 shards stacked on one card: dense
against compact exchange x routing x replica x Zipf skew, the port of the
JAX package's ``scripts/exp_ici_exchange.py`` (run there on 8 virtual CPU
devices).

The reference's skew experiment (``exp_cache_size_and_skew.py``) charts
the cache hit rate; on a mesh the matching currency is the bytes a query
puts on the wire between shards: replica hits and routed locality keep
lanes on the exchange's diagonal, which never crosses it. The numbers are
the search's own counters (``parallel/sharded.py``: ``ici_bytes``,
``ici_lanes``, ``rpc_rounds``, the replica's hits and misses), not a model.

The set is the JAX script's: ``synthetic_dataset(20,000, 32, 1,024 queries,
seed=7)``, a native graph at M=16, efc=100 (8 threads; ``graph_path`` loads a
saved one instead); for Zipf alpha 0 and 1.25 a stream of 2,048 queries
(``skewed_workload(seed=3)``), served at ef=64, batch 256 by a
``ShardedIndex`` on ``shard_mesh(8)`` for each exchange (dense, compact,
compact with the slack ladder) and each (routing, replica share) of (none,
0), (none, 0.15), (static, 0.15): 18 rows.

    python scripts/torch_exp_ici_exchange.py                 # on the card
    python scripts/torch_exp_ici_exchange.py --device cpu    # CPU, minutes

Each row is printed and appended as one JSON line to
``results/torch_ici_exchange.jsonl`` (``--out``; with the card's name and
power limit, the pass's wall and the kernels' launches), and in the JAX
script's columns to the CSV of the same name.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.config import HNSWParams, SearchParams  # noqa: E402
from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.graph.soa import build_graph  # noqa: E402
from shine_tpu_torch.io import load_graph, recall_at_k, synthetic_dataset  # noqa: E402
from shine_tpu_torch.io.skew import skewed_workload  # noqa: E402
from shine_tpu_torch.parallel import ShardedIndex, shard_mesh  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    Recorder,
    card_line,
    launches,
    reset_launches,
)
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

OUT = os.path.join(ROOT, "results", "torch_ici_exchange.jsonl")
CSV_FIELDS = ("exchange", "routing", "cache_ratio", "zipf", "recall", "ici_bytes_per_q",
              "ici_lanes_per_q", "rpc_rounds", "cache_hit_rate")
EXCHANGES = (("dense", False), ("compact", False), ("compact", True))
ROUTES = ((None, 0.0), (None, 0.15), ("static", 0.15))  # (routing, replica share)
S = 8
PARAMS = HNSWParams(M=16, ef_construction=100)
THREADS, EF, BATCH = 8, 64, 256  # the JAX script's


@dataclasses.dataclass
class Config:
    n: int = 20_000
    d: int = 32
    pool: int = 1024
    nq: int = 2048
    alphas: tuple = (0.0, 1.25)
    exchanges: tuple = EXCHANGES
    routes: tuple = ROUTES
    graph_path: str | None = None  # a saved graph of the set in place of the build


def serve(graph, mesh, queries, gt, exchange: str, adaptive: bool, routing,
          cache_ratio: float, dev: torch.device) -> dict:
    """One grid point: a fresh ShardedIndex, one pass over the stream; the
    JAX script's row, the pass's wall and the kernels' launches."""
    idx = ShardedIndex(graph, mesh, cache_capacity=int(cache_ratio * graph.n),
                       routing=routing or False)
    sp = SearchParams(k=10, ef=EF, exchange=exchange, adaptive_slack=adaptive)
    reset_launches()
    t0 = sync_clock(dev)
    ids, _ = idx.search(queries, sp, batch_size=BATCH)
    seconds = sync_clock(dev) - t0
    nq = len(queries)
    tot = idx.cache_hits + idx.cache_misses
    return {
        "exchange": exchange + ("+adaptive" if adaptive else ""),
        "routing": routing or "none", "cache_ratio": cache_ratio,
        "recall": recall_at_k(ids, gt, 10), "ici_bytes_per_q": idx.ici_bytes / nq,
        "ici_lanes_per_q": idx.ici_lanes / nq, "rpc_rounds": idx.rpc_rounds,
        "cache_hit_rate": idx.cache_hits / tot if tot else 0.0,
        "ici_bytes": idx.ici_bytes, "ici_lanes": idx.ici_lanes,
        "cache_hits": idx.cache_hits, "cache_misses": idx.cache_misses,
        "readbacks": idx.readbacks, "seconds": seconds, "qps": nq / seconds,
        "launches": launches()}


def write_csv(path: str, rows: list[dict]) -> None:
    """The rows in the JAX script's columns, appended (a header when new)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if new:
            w.writeheader()
        for r in rows:
            w.writerow({k: r[k] for k in CSV_FIELDS})
    print(f"# wrote {len(rows)} rows -> {path}", flush=True)


def run(cfg: Config, dev: torch.device, out: str) -> list[dict]:
    """Every grid point; returns the rows' records."""
    record = Recorder(out, {"n": cfg.n, "d": cfg.d, "nq": cfg.nq, "S": S,
                            "device": str(dev), "card": card_line(dev)})
    ds = synthetic_dataset(n=cfg.n, dim=cfg.d, num_queries=cfg.pool, seed=7, gt_k=10)
    if cfg.graph_path:
        graph = load_graph(cfg.graph_path)
    else:
        graph = build_graph(ds.base, PARAMS, threads=THREADS)
    mesh = shard_mesh(S, device=dev)
    rows = []
    for alpha in cfg.alphas:
        _, q, pool_idx = skewed_workload(ds.queries, total=cfg.nq, alpha=alpha,
                                         warmup=0, seed=3)
        gt = ds.ground_truth[pool_idx]
        for exchange, adaptive in cfg.exchanges:
            for routing, cache_ratio in cfg.routes:
                rows.append(record({**serve(graph, mesh, q, gt, exchange, adaptive,
                                            routing, cache_ratio, dev),
                                    "zipf": alpha}))
    write_csv(os.path.splitext(out)[0] + ".csv", rows)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    return run(Config(), resolve_device(args.device), args.out)


if __name__ == "__main__":
    main()
