#!/usr/bin/env python
"""Zipf skew x serving budget on one card: the port of the JAX package's
``scripts/exp_skew_capacity.py`` (phase ``routed``) and
``scripts/exp_routed_skew.py`` (phase ``ivf``), the reference's headline
experiment (``exp_cache_size_and_skew.py``: Zipf alpha x cache budget).

``routed`` (the default): a pool of queries near the rows of the row-keyed
base of seed 17, drawn as the JAX script draws it (k0..k3 =
split(PRNGKey(17), 4), centres normal(k0, (64, d)) * 4, pool ids randint(k2,
(pool,), 0, n), rows regen_rows(k1, centres, ids) + 0.3 * normal(k3)); the
routed split index ``build_routed_split(n, d, row_source=(k1, centres),
cap_target, cls, cap_slack=1.05, int8, seed=17, queries=pool)`` with no
resident base, its stage seconds, C, cap and the card's peak; then the
grid alpha x probes p x shared multiplier: each alpha's stream is
``perm[zipf_ranks(pool, alpha, stream, seed=7)]`` with ``perm =
default_rng(31).permutation(pool)`` (popularity decorrelated from id), served
with P = mult * p shared clusters a tile of 32, no spill (``fallback=0``:
a coverage loss shows in recall), batch 2048, the queries staged once. Each
cell records P, the budget share P/C, recall@10, the coverage, QPS (the
best of two timed passes after a warm-up pass) and the kernels' launches in
one pass (K4's ``routed_classmax_scan``, ``regen_score``); on a card, one
batch of the first alpha is profiled at each p (device time by kernel, busy
share). The cells also go, in the JAX script's columns, to a CSV beside the
JSON-lines file.

``ivf``: ``synthetic_dataset(n, d, queries, seed=7)``, ``IVFIndex(base,
seed=7)`` built on the host and uploaded to the card; for each alpha,
``skewed_workload(pool, total=queries, alpha, warmup=0, seed=3)`` served
by ``search_routed(probes=16, shared=128, tile=64, with_stats=True)`` with
the default spill: recall@10, coverage, spilled queries, QPS.

    python scripts/torch_exp_skew.py                          # routed, 4,194,304 rows
    SHINE_SKC_SHARED=3,6,12 python scripts/torch_exp_skew.py  # the budget axis
    python scripts/torch_exp_skew.py ivf                      # routed IVF, 200,000 rows
    SHINE_SKC_CPU=1 SHINE_SKC_N=16384 python scripts/torch_exp_skew.py --device cpu

Env (the JAX scripts' knobs): SHINE_SKC_N (4,194,304), SHINE_SKC_STREAM
(8192), SHINE_SKC_SHARED ("12"), SHINE_SKC_CPU=1 (the JAX script's CPU
sizes: 65,536 rows, a pool of 1,024, a stream of 2,048, cap_target 1024,
cls 256); SHINE_SKEW_N (200,000), SHINE_SKEW_D (128), SHINE_SKEW_Q
(10,000). Every record is printed and appended as one JSON line to
``results/torch_skew.jsonl`` (``--out``), with the card's name and power
limit; the cells' CSV is the same path with ``.csv``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import recall_at_k, synthetic_dataset  # noqa: E402
from shine_tpu_torch.io.skew import skewed_workload, zipf_ranks  # noqa: E402
from shine_tpu_torch.models.ivf import IVFIndex, route_batch  # noqa: E402
from shine_tpu_torch.models.routed_split import build_routed_split  # noqa: E402
from shine_tpu_torch.ops import threefry as tf  # noqa: E402
from shine_tpu_torch.ops.regen import regen_rows  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    PEAK_BF16,
    Recorder,
    best_qps,
    bound_ms,
    card_line,
    launches,
    peak_gb,
    profile_once,
    reset_launches,
    reset_peak,
)
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

SEED = 17
BATCH = 2048
TILE = 32
ALPHAS = (0.0, 0.75, 1.25)
PROBES = (16, 32, 64)
OUT = os.path.join(ROOT, "results", "torch_skew.jsonl")
CSV_FIELDS = ("alpha", "p", "P", "budget_frac", "qps", "recall10", "coverage")
IVF_ROUTE = {"probes": 16, "shared": 128, "tile": 64}


@dataclasses.dataclass
class Config:
    n: int = 4_194_304
    d: int = 128
    pool: int = 2048
    stream: int = 8192
    cap_target: int = 4096
    cls: int = 1024
    mults: tuple = (12,)
    alphas: tuple = ALPHAS
    probes: tuple = PROBES
    ivf_n: int = 200_000
    ivf_d: int = 128
    ivf_q: int = 10_000

    @classmethod
    def from_env(cls) -> "Config":
        env = os.environ.get
        cpu = env("SHINE_SKC_CPU") == "1"
        return cls(
            n=int(env("SHINE_SKC_N", 65_536 if cpu else 4_194_304)),
            pool=1024 if cpu else 2048,
            stream=int(env("SHINE_SKC_STREAM", 2048 if cpu else 8192)),
            cap_target=1024 if cpu else 4096, cls=256 if cpu else 1024,
            mults=tuple(int(x) for x in env("SHINE_SKC_SHARED", "12").split(",") if x),
            ivf_n=int(env("SHINE_SKEW_N", 200_000)), ivf_d=int(env("SHINE_SKEW_D", 128)),
            ivf_q=int(env("SHINE_SKEW_Q", 10_000)))


def make_pool(cfg: Config, dev: torch.device):
    """The JAX script's query pool: (k1, centres) of the row source, the
    pool's row ids (int64, on the host) and its rows (pool, d) f32 numpy."""
    k0, k1, k2, k3 = tf.split(tf.prng_key(SEED), 4)
    centers = (tf.normal(k0, (64, cfg.d)) * 4.0).to(dev)
    qidx = tf.randint(k2, (cfg.pool,), 0, cfg.n)
    anchors = regen_rows(k1, centers, qidx.to(dev))
    pool = anchors + 0.3 * tf.normal(k3, (cfg.pool, cfg.d)).to(dev)
    return (k1, centers), qidx.numpy(), pool.cpu().numpy()


def stream_ids(cfg: Config, alpha: float) -> np.ndarray:
    """The pool indices of one alpha's stream: Zipf ranks mapped through a
    fixed permutation, so that popularity does not follow the pool id."""
    perm = np.random.default_rng(31).permutation(cfg.pool)
    return perm[zipf_ranks(cfg.pool, alpha, cfg.stream, seed=7)]


def digest(ids: np.ndarray) -> str:
    """A stream's fingerprint: the sha1 of its pool indices as int64."""
    return hashlib.sha1(np.ascontiguousarray(ids, np.int64).tobytes()).hexdigest()


def k4_work(idx, q: torch.Tensor, p: int, P: int) -> dict:
    """K4's least time on one batch ``q`` (on the card): the bf16 products
    of each tile's queries with the real clusters its grant names, at width
    d, or the bytes of every granted cluster read once (rows with their nrm
    and scl), the queries, the grant and the class outputs, whichever takes
    longer (``chip_smoke.py``'s K4 bound)."""
    _, _, cols, _, _ = route_batch(idx.centroids, q, metric=idx.metric, p=p, P=P,
                                   T=TILE, C=idx.C)
    real = cols < idx.C
    uniq = int(torch.unique(cols[real]).numel())
    B, d = q.shape[0], idx.dim
    nbytes = (uniq * idx.cap * (d * idx.comp.element_size() + 8) + B * d * 2
              + B * idx.cls * 8 + cols.numel() * 4)
    ms, by = bound_ms(nbytes, 2.0 * TILE * int(real.sum()) * idx.cap * d, PEAK_BF16)
    return {"real_columns": int(real.sum()), "clusters_read": uniq, "bound_ms": ms,
            "bound_by": by}


def phase_routed(cfg: Config, dev: torch.device, emit) -> list[dict]:
    """The routed split index and its alpha x p x multiplier grid."""
    reset_peak(dev)
    row_source, qidx, pool = make_pool(cfg, dev)
    timings: dict = {}
    t0 = sync_clock(dev)
    idx, gt = build_routed_split(
        cfg.n, cfg.d, row_source=row_source, cap_target=cfg.cap_target, cls=cfg.cls,
        cap_slack=1.05, comp_dtype="int8", seed=SEED, queries=pool,
        log=lambda m: print(m, flush=True), timings=timings)
    emit({"stage": "ingest", "seconds": sync_clock(dev) - t0, "timings": timings,
          "C": idx.C, "cap": idx.cap, "pool_ids": [int(qidx.min()), int(qidx.max())],
          "base_resident": idx.base_dev is not None, "peak_gb": peak_gb(dev)})
    batch = min(BATCH, cfg.stream)
    cells = []
    for alpha in cfg.alphas:
        sel = stream_ids(cfg, alpha)
        qs, gts = pool[sel], gt[sel]
        pre = idx.preload(qs, batch_size=batch)
        for p in cfg.probes:
            for mult in cfg.mults:
                kw = dict(probes=p, shared=mult * p, tile=TILE, batch_size=batch,
                          preloaded=pre, with_dists=False, fallback=0)
                reset_peak(dev)
                reset_launches()
                idx.search(qs, 10, **kw)
                passes = launches()
                ids, qps = best_qps(lambda: idx.search(qs, 10, **kw), len(qs), dev)
                P = min(mult * p, TILE * p, idx.C)  # the index's grant rule
                rec = {
                    "stage": "cell", "alpha": alpha, "p": p, "mult": mult, "P": mult * p,
                    "P_granted": P, "budget_frac": mult * p / idx.C, "qps": qps,
                    "recall10": recall_at_k(ids, gts, 10), "coverage": idx.last_coverage,
                    "unique_queries": int(np.unique(sel).size),
                    "stream_digest": digest(sel), "launches": passes,
                    "peak_gb": peak_gb(dev)}
                if dev.type == "cuda" and alpha == cfg.alphas[0] and mult == cfg.mults[-1]:
                    # one batch: where its device time goes at this p
                    one = idx.preload(qs[:batch], batch_size=batch)
                    prof = profile_once(lambda: idx.search(
                        qs[:batch], 10, **{**kw, "preloaded": one}))
                    k4 = k4_work(idx, one[0], p, P)
                    k4["ms"] = sum(k["ms"] for k in prof["kernels"]
                                   if "classmax2_kernel" in k["name"])
                    rec.update(profile=prof, k4=k4)
                cells.append(emit(rec))
    return cells


def phase_ivf(cfg: Config, dev: torch.device, emit) -> list[dict]:
    """Routed IVF under each alpha's workload."""
    ds = synthetic_dataset(n=cfg.ivf_n, dim=cfg.ivf_d, num_queries=cfg.ivf_q, seed=7,
                           gt_k=10)
    reset_peak(dev)
    timings: dict = {}
    t0 = sync_clock(dev)
    ivf = IVFIndex(ds.base, seed=7, device=dev, timings=timings)
    emit({"stage": "ivf_build", "n": cfg.ivf_n, "d": cfg.ivf_d, "seconds":
          sync_clock(dev) - t0, "timings": timings, "clusters": ivf.data.num_clusters,
          "cap": ivf.data.cap, "peak_gb": peak_gb(dev)})
    recs = []
    for alpha in cfg.alphas:
        _, q, pool_idx = skewed_workload(ds.queries, total=cfg.ivf_q, alpha=alpha,
                                         warmup=0, seed=3)
        pre = ivf.preload(q, batch_size=min(4096, len(q)))
        stats: dict = {}

        def routed():
            ids, dists, st = ivf.search_routed(q, 10, **IVF_ROUTE, preloaded=pre,
                                               with_stats=True)
            stats.update(st)
            return ids, dists

        reset_launches()
        routed()
        passes = launches()
        ids, qps = best_qps(routed, len(q), dev)
        recs.append(emit({
            "stage": "ivf_alpha", "n": cfg.ivf_n, "d": cfg.ivf_d, "alpha": alpha,
            **IVF_ROUTE, "qps": qps, "recall10": recall_at_k(ids, ds.ground_truth[pool_idx], 10),
            "coverage": stats["probe_coverage"], "fallback_queries": stats["fallback_queries"],
            "launches": passes, "peak_gb": peak_gb(dev)}))
    return recs


def write_csv(path: str, cells: list[dict]) -> None:
    """The cells in the JAX script's columns, appended (a header when new)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if new:
            w.writeheader()
        for c in cells:
            w.writerow({k: c[k] for k in CSV_FIELDS})
    print(f"# wrote {path}", flush=True)


def run(cfg: Config, dev: torch.device, out: str, phase: str = "routed") -> list[dict]:
    """One phase, ``routed`` or ``ivf``; returns its records."""
    if phase not in ("routed", "ivf"):
        raise ValueError(f"unknown phase {phase!r} (use routed or ivf)")
    head = {"phase": phase, "device": str(dev), "card": card_line(dev)}
    if phase == "routed":
        head.update(n=cfg.n, d=cfg.d, pool=cfg.pool, stream=cfg.stream,
                    cap_target=cfg.cap_target, cls=cfg.cls, seed=SEED)
    record = Recorder(out, head)
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    if phase == "routed":
        write_csv(os.path.splitext(out)[0] + ".csv", phase_routed(cfg, dev, emit))
    else:
        phase_ivf(cfg, dev, emit)
    return recs


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", nargs="?", default="routed", help="routed (the default) or ivf")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--nq", type=int, default=None,
                    help="queries of the stream (routed) or the workload (ivf); "
                         "SHINE_SKC_STREAM / SHINE_SKEW_Q otherwise")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    cfg = Config.from_env()
    if args.nq is not None:
        cfg = dataclasses.replace(cfg, stream=args.nq, ivf_q=args.nq)
    return run(cfg, resolve_device(args.device), args.out, args.phase)


if __name__ == "__main__":
    main()
