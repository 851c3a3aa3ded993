#!/usr/bin/env python
"""The sustained stream's batch size at the 200k headline shape, on one
card: the port of the JAX package's ``scripts/sustained_b_sweep.py``.

The sustained row replays the query set as one stream staged on the device
once (``FastFlatIndex.preload``; the reference replays Zipf-sampled queries
with replacement, ``scripts/data/create_queries.py`` + ``skew.py``), so the
fixed cost of a call is spread over the stream and each batch's own terms
bind: its launches, its host work and the scan over every row. A larger B
spreads those over more queries until the scan's own time, linear in B,
dominates. FastFlat over ``synthetic_dataset(200,704, 128, 10,000 queries,
seed=7)`` (its exact top-10 from the device); for each B the queries tiled
``reps`` times and cut to ``nq_s = max(B, nq * reps // B * B)``, served in
``nq_s // B`` batches: QPS (the best of 3 passes after a warm-up), ms a
batch, recall@10 and the kernels' launches in one pass.

    python scripts/torch_sustained_b_sweep.py                       # on the card
    SHINE_SB_N=8192 SHINE_SB_D=32 SHINE_SB_Q=512 SHINE_SB_REPS=2 SHINE_SB_BS=512,1024 \\
        python scripts/torch_sustained_b_sweep.py --device cpu --out build/sb_cpu.jsonl

Env (the JAX script's): SHINE_SB_N (200,704), SHINE_SB_D (128), SHINE_SB_Q
(10,000), SHINE_SB_REPS (5), SHINE_SB_BS ("2048,4096,8192,16384"); its
SHINE_SB_CPU=1 is ``--device cpu`` here. Every record is printed and
appended as one JSON line to ``results/torch_sustained_b_sweep.jsonl``
(``--out``), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import recall_at_k, synthetic_dataset  # noqa: E402
from shine_tpu_torch.models.flat import FastFlatIndex  # noqa: E402
from shine_tpu_torch.ops.distance import exact_knn  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    Recorder,
    best_qps,
    card_line,
    launches,
    reset_launches,
)

OUT = os.path.join(ROOT, "results", "torch_sustained_b_sweep.jsonl")
PASSES = 3  # timed, the best kept, after a warm-up


@dataclasses.dataclass
class Config:
    n: int = 200_704
    d: int = 128
    nq: int = 10_000
    reps: int = 5
    batches: tuple = (2048, 4096, 8192, 16384)

    @classmethod
    def from_env(cls) -> "Config":
        env = os.environ.get
        return cls(n=int(env("SHINE_SB_N", 200_704)), d=int(env("SHINE_SB_D", 128)),
                   nq=int(env("SHINE_SB_Q", 10_000)), reps=int(env("SHINE_SB_REPS", 5)),
                   batches=tuple(int(b) for b in env(
                       "SHINE_SB_BS", "2048,4096,8192,16384").split(",")))


def stream_size(nq: int, reps: int, b: int) -> int:
    """The stream's length at batch ``b``: ``reps`` copies of the ``nq``
    queries cut to whole batches, at least one."""
    return max(b, nq * reps // b * b)


def run(cfg: Config, dev: torch.device, out: str) -> list[dict]:
    """Every batch size once; returns the records."""
    record = Recorder(out, {"n": cfg.n, "d": cfg.d, "nq": cfg.nq, "reps": cfg.reps,
                            "device": str(dev), "card": card_line(dev)})
    ds = synthetic_dataset(n=cfg.n, dim=cfg.d, num_queries=cfg.nq, seed=7,
                           compute_gt=False)
    gt, _ = exact_knn(torch.from_numpy(ds.base).to(dev),
                      torch.from_numpy(ds.queries).to(dev), 10)
    gt = gt.cpu().numpy()
    fast = FastFlatIndex(ds.base, device=dev)
    recs = []
    for b in cfg.batches:
        nq_s = stream_size(cfg.nq, cfg.reps, b)
        qs = np.tile(ds.queries, (cfg.reps, 1))[:nq_s]
        gts = np.tile(gt, (cfg.reps, 1))[:nq_s]
        pre = fast.preload(qs, batch_size=b)

        def stream():
            return fast.search(qs, 10, batch_size=b, preloaded=pre, with_dists=False)

        reset_launches()
        stream()
        passes = launches()
        ids, qps = best_qps(stream, nq_s, dev, reps=PASSES)
        recs.append(record({
            "batch": b, "nq_s": nq_s, "dispatches": nq_s // b, "qps": qps,
            "ms_per_dispatch": nq_s / qps / (nq_s // b) * 1e3,
            "recall10": recall_at_k(ids, gts, 10), "launches": passes}))
        del pre
    return recs


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    return run(Config.from_env(), resolve_device(args.device), args.out)


if __name__ == "__main__":
    main()
