#!/usr/bin/env python
"""The cluster-sharded routed path's owned-lane counters, 8 shards stacked
on one card: the port of the JAX package's ``scripts/exp_routed_sharded.py``
(run there on 8 virtual CPU devices).

The counters are measured on the devices and do not depend on the platform:
each shard's owned-lane occupancy (``lanes_used``, summed over the shards),
the lowest-priority columns dropped for want of a lane (``overflow``), the
routing coverage and recall. At P_loc = P every shard scans only what it
owns (the sum over shards is the granted lanes, an S-fold split of the
single-card scan); shrinking P_loc trades overflow for a narrower window.

The set, the build and the search are ``shine_tpu_torch/parallel/lane_study.py``'s
(the JAX script's, drawn by the port's threefry); for P_loc 32/16/10/6/4
one search over ``nq`` = 256 queries.

    python scripts/torch_exp_routed_sharded.py                 # on the card
    python scripts/torch_exp_routed_sharded.py --device cpu    # CPU, minutes

Every record is printed and appended as one JSON line to
``results/torch_routed_sharded_counters.jsonl`` (``--out``), with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.parallel.lane_study import ROUTE, S, build, serve, study_set  # noqa: E402
from shine_tpu_torch.utils.meter import Recorder, card_line  # noqa: E402

OUT = os.path.join(ROOT, "results", "torch_routed_sharded_counters.jsonl")


@dataclasses.dataclass
class Config:
    n: int = 65_536
    nq: int = 256
    p_locs: tuple = (32, 16, 10, 6, 4)


def run(cfg: Config, dev: torch.device, out: str) -> list[dict]:
    """The build and every P_loc; returns the records."""
    record = Recorder(out, {"device": str(dev), "card": card_line(dev)})
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    row_source, queries = study_set(cfg.n, cfg.nq, dev)
    idx, gt, built = build(cfg.n, dev, queries, row_source)
    emit(built)
    T = ROUTE["T"]
    for P_loc in cfg.p_locs:
        got = serve(idx, queries, gt, P_loc, dev)
        emit({"stage": "counters", "n": cfg.n, "S": S, "C": idx.C, **ROUTE,
              "P_loc": P_loc, "lanes_used": got.pop("lanes_used"),
              "lane_window": (cfg.nq // T) * S * P_loc,
              "singlechip_window": (cfg.nq // T) * ROUTE["P"], **got})
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
