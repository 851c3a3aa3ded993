#!/usr/bin/env python
"""Zipf skew x the owned-lane budget for the sharded capacity families, 8
shards stacked on one card: the port of the JAX package's
``scripts/exp_skew_capacity_mesh.py`` (run there on 8 virtual CPU devices),
the mesh leg of the reference's cache-size-and-skew experiment
(``exp_cache_size_and_skew.py``).

Routed leg: Zipf(alpha) resampling concentrates the stream on popular
queries, so the probe grants concentrate on the shards that own the hot
clusters; the owned-lane budget P_loc is each shard's serving resource (the
cache ratio's analogue). The index of ``shine_tpu_torch/parallel/lane_study.py``
(the routed study's rows and build, with a pool of 256 queries); for alpha 0/0.75/1.25
a stream of 512 pool queries ``perm[zipf_ranks(256, alpha, 512, seed=7)]``
(``perm = default_rng(31).permutation(256)``), served at P_loc 32/12/6,
probes 16, shared 32, tile 32, kk 64, no spill: owned lanes, window,
overflow, coverage, recall@10.

FastFlat leg: ``ShardedFastFlatIndex.from_ext`` over
``device_rowkeyed_ext_dataset(65,536, 32, 256 queries, seed=25, mesh=)`` with
its row source, at kb 16/32/64 for each alpha's stream (the same draw): every
shard scans its whole row range for every query, so its cost counters
depend on (nq, kb) alone, whatever the skew.

    python scripts/torch_exp_skew_capacity_mesh.py                 # on the card
    python scripts/torch_exp_skew_capacity_mesh.py --device cpu    # CPU, minutes

Every record is printed and appended as one JSON line to
``results/torch_skew_capacity_mesh.jsonl`` (``--out``), with the card's
name and power limit; the routed cells go, in the JAX script's columns, to
the CSV of the same name (written anew).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import recall_at_k  # noqa: E402
from shine_tpu_torch.io.device_synth import device_rowkeyed_ext_dataset  # noqa: E402
from shine_tpu_torch.io.skew import zipf_ranks  # noqa: E402
from shine_tpu_torch.parallel import ShardedFastFlatIndex, shard_mesh  # noqa: E402
from shine_tpu_torch.parallel.lane_study import (  # noqa: E402
    BATCH,
    D,
    ROUTE,
    S,
    build,
    serve,
    study_set,
)
from shine_tpu_torch.utils.meter import (  # noqa: E402
    Recorder,
    card_line,
    launches,
    reset_launches,
)

OUT = os.path.join(ROOT, "results", "torch_skew_capacity_mesh.jsonl")
CSV_FIELDS = ("alpha", "P_loc", "lanes_used", "lane_window", "overflow", "coverage",
              "recall10")


@dataclasses.dataclass
class Config:
    n: int = 65_536
    pool: int = 256
    stream: int = 512
    alphas: tuple = (0.0, 0.75, 1.25)
    p_locs: tuple = (32, 12, 6)
    kbs: tuple = (16, 32, 64)  # the FastFlat leg's


def stream_ids(cfg: Config, alpha: float) -> np.ndarray:
    """The pool indices of one alpha's stream (Zipf ranks through a fixed
    permutation, so that popularity does not follow the pool id)."""
    perm = np.random.default_rng(31).permutation(cfg.pool)
    return perm[zipf_ranks(cfg.pool, alpha, cfg.stream, seed=7)]


def run(cfg: Config, dev: torch.device, out: str) -> list[dict]:
    """Both legs; returns the records."""
    record = Recorder(out, {"device": str(dev), "card": card_line(dev)})
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    row_source, pool = study_set(cfg.n, cfg.pool, dev)
    idx, gt, built = build(cfg.n, dev, pool, row_source)
    emit(built)
    cells = []
    for alpha in cfg.alphas:
        sel = stream_ids(cfg, alpha)
        for P_loc in cfg.p_locs:
            got = serve(idx, pool[sel], gt[sel], P_loc, dev)
            cells.append(emit({
                "stage": "routed", "n": cfg.n, "alpha": alpha, "P_loc": P_loc, **ROUTE,
                "lanes_used": got.pop("lanes_used"),
                "lane_window": (cfg.stream // ROUTE["T"]) * S * P_loc, **got}))
    with open(os.path.splitext(out)[0] + ".csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        w.writeheader()
        for c in cells:
            w.writerow({k: c[k] for k in CSV_FIELDS})
    del idx
    mesh = shard_mesh(S, device=dev)
    ds = device_rowkeyed_ext_dataset(n=cfg.n, dim=D, num_queries=cfg.pool, seed=25,
                                     gt_k=10, mesh=mesh)
    ff = ShardedFastFlatIndex.from_ext(ds.ext_dev, ds.n, mesh, dim=D,
                                       row_source=ds.row_source)
    fpool = np.asarray(ds.queries)  # this leg's pool, with its own truth
    for alpha in cfg.alphas:
        sel = stream_ids(cfg, alpha)
        for kb in cfg.kbs:
            reset_launches()
            ids, _ = ff.search(fpool[sel], 10, kb=kb, batch_size=BATCH)
            cc = ff.cost_counters(len(sel), 10, kb=kb)
            emit({"stage": "fastflat_sharded", "n": ds.n, "alpha": alpha, "kb": kb,
                  "ici_exchange_bytes": cc["ici_exchange_bytes"],
                  "scanned_rows": cc["scanned_rows"],
                  "recall10": recall_at_k(ids, ds.ground_truth[sel], 10),
                  "launches": launches()})
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
