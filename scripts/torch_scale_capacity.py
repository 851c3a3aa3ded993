#!/usr/bin/env python
"""Capacity serving of shine_tpu_torch on one card: how many row-keyed rows
one H100 serves, through the routed split layout and the flat split layout.

Both recipes are those of the JAX package's ``scripts/scale_capacity_routed.py``
and ``scripts/scale_capacity_split.py``: d=128 rows regenerated by id from
the row-keyed recipe of seed 17 (``io/device_synth.py``), 2,048 queries, the
exact f32 top-10 folded while the rows stream, recall@10 against it and the
distance-tolerance recall from regenerated rows (``recall_at_k_eps_regen``).

    python scripts/torch_scale_capacity.py routed   # build_routed_split, served at SHINE_CR_SWEEP
    python scripts/torch_scale_capacity.py split    # SplitFlatIndex.from_parts, served at SHINE_CAPS_KB

``routed`` builds ``build_routed_split(row_source=...)`` with no resident base
(the f32 base never exists), its stage seconds in ``timings``, then serves each
p:P:T[:kk] point of the sweep with no spill (``fallback=0``) and the first
point again with the spill (``fallback=0.5``, the T=16 pass). ``split`` ingests
``device_rowkeyed_split_dataset`` and serves ``SplitFlatIndex.from_parts`` with
its row source at the auto knobs for each kb. QPS is the best of two timed
passes after a warm-up pass over the staged queries. Every record is printed
and appended as one JSON line to ``results/torch_scale_capacity.jsonl``
(``--out`` to change it), with the card's name and power limit.

Env, as in the JAX scripts. routed: SHINE_CR_N (41,943,040), SHINE_CR_CAP
(4096), SHINE_CR_CLS (1024), SHINE_CR_SLACK (1.05), SHINE_CR_SWEEP ("p:P:T[:kk],..."),
SHINE_CR_RECENTER=1 (serve the sweep again after ``recenter_routing``).
split: SHINE_CAPS_N (41,943,040), SHINE_CAPS_D (128), SHINE_CAPS_COMP
(int8|bf16), SHINE_CAPS_KB ("32,64"), SHINE_CAPS_MODE (auto|exact|turbo),
SHINE_CAPS_PRERANK (0). Both: SHINE_GT_CROSSCHECK (1: certify the card's
exact scorer against numpy on SHINE_GT_NSUB = 524,288 regenerated rows;
fails at overlap <= 0.995). The JAX routed script's checkpoint save
(SHINE_CR_SAVE) is left out: a 100.7M-row index is 14.8 GB of tables.

``--device cpu`` runs the same script on the CPU (the kernels' plain
versions) at a small SHINE_CR_N / SHINE_CAPS_N.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import (  # noqa: E402
    margin_mask,
    recall_at_k,
    recall_at_k_eps_regen,
)
from shine_tpu_torch.io import device_synth as tds  # noqa: E402
from shine_tpu_torch.models.flat import SplitFlatIndex  # noqa: E402
from shine_tpu_torch.models.routed_split import build_routed_split  # noqa: E402
from shine_tpu_torch.utils.meter import Recorder, best_qps, card_line, peak_gb  # noqa: E402
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

D = 128
NQ = 2048
SEED = 17
OUT = os.path.join(ROOT, "results", "torch_scale_capacity.jsonl")
MIN_CROSSCHECK = 0.995
MODES = {"auto": {}, "exact": {"keep2": True, "cls": 1024},
         "turbo": {"keep2": False, "cls": 4096}}


def _env(name: str, default):
    return type(default)(os.environ.get(name, default))


def _sweep(text: str) -> list[tuple[int, int, int, int]]:
    """"p:P:T[:kk],..." -> [(p, P, T, kk)], kk 0 (8k) when left out."""
    return [tuple((list(map(int, s.split(":"))) + [0])[:4]) for s in text.split(",")]


def _crosscheck(row_source, queries: np.ndarray, emit) -> list[dict]:
    if os.environ.get("SHINE_GT_CROSSCHECK", "1") != "1":
        return []
    t0 = time.perf_counter()
    ov = tds.rowkeyed_scorer_crosscheck(row_source, queries,
                                        n_sub=_env("SHINE_GT_NSUB", 524_288))
    rec = emit({"stage": "gt-crosscheck", "gt_overlap": ov,
                "seconds": time.perf_counter() - t0})
    if ov <= MIN_CROSSCHECK:
        raise SystemExit(f"the card's exact scorer disagrees with numpy (overlap {ov})")
    return [rec]


def run_routed(dev: torch.device, out: str, nq: int) -> list[dict]:
    n = _env("SHINE_CR_N", 41_943_040)
    cap, cls = _env("SHINE_CR_CAP", 4096), _env("SHINE_CR_CLS", 1024)
    slack = _env("SHINE_CR_SLACK", 1.05)
    sweep = _sweep(os.environ.get("SHINE_CR_SWEEP",
                                  "16:96:32,16:128:32,16:192:32,32:192:32,32:256:32"))
    emit = Recorder(out, {"family": "routed", "n": n, "d": D, "nq": nq, "cap": cap,
                          "cls": cls, "slack": slack, "device": str(dev),
                          "card": card_line(dev)})
    recs = []
    k1, centers, q_dev = tds._rowkeyed_recipe(n, D, nq, 64, SEED, True, dev)
    queries = q_dev.cpu().numpy()
    row_source = (k1, centers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    t0 = sync_clock(dev)
    idx, gt = build_routed_split(
        n, D, row_source=row_source, cap_target=cap, cls=cls, cap_slack=slack,
        comp_dtype="int8", seed=SEED, queries=queries, gt_k=11,
        log=lambda m: print(m, flush=True), timings=timings)
    build_s = sync_clock(dev) - t0
    table_gb = (idx.comp.numel() * idx.comp.element_size() + idx.aux_r.numel() * 4
                + idx.gid.numel() * 4) / 1e9
    recs.append(emit({"stage": "ingest", "seconds": build_s, "timings": timings,
                      "C": idx.C, "cap_actual": idx.cap,
                      "fill": n / (idx.C * idx.cap), "table_gb": table_gb,
                      "peak_gb": peak_gb(dev), "base_resident": idx.base_dev is not None}))
    recs += _crosscheck(row_source, queries, emit)
    mm = margin_mask(queries, None, gt, 10, row_source=row_source)
    recs.append(emit({"stage": "margin", "margin_frac": float(mm.mean())}))
    batch = min(NQ, nq)
    pre = idx.preload(queries, batch_size=batch)

    def point(stage: str, p: int, P: int, T: int, kk: int, fallback: float) -> dict:
        ids, qps = best_qps(lambda: idx.search(
            queries, 10, probes=p, shared=P, tile=T, kk=kk, batch_size=batch,
            preloaded=pre, with_dists=False, fallback=fallback), nq, dev)
        return emit({"stage": stage, "p": p, "P": P, "T": T, "kk": kk, "qps": qps,
                     "recall10": recall_at_k(ids, gt, 10),
                     "recall10_eps": recall_at_k_eps_regen(ids, queries, row_source, gt, 10),
                     "recall10_margin": recall_at_k(ids[mm], gt[mm], 10),
                     "coverage": idx.last_coverage,
                     "fallback_queries": idx.last_fallback,
                     "peak_gb": peak_gb(dev)})

    for p, P, T, kk in sweep:
        recs.append(point("search", p, P, T, kk, 0.0))
    p, P, T, kk = sweep[0]
    recs.append(point("search_fallback", p, P, T, kk, 0.5))
    if os.environ.get("SHINE_CR_RECENTER") == "1":
        t0 = sync_clock(dev)
        idx.recenter_routing()
        recs.append(emit({"stage": "recenter", "seconds": sync_clock(dev) - t0}))
        for p, P, T, kk in sweep:
            recs.append(point("search_recentered", p, P, T, kk, 0.0))
    return recs


def run_split(dev: torch.device, out: str, nq: int) -> list[dict]:
    n, d = _env("SHINE_CAPS_N", 41_943_040), _env("SHINE_CAPS_D", D)
    comp = os.environ.get("SHINE_CAPS_COMP", "int8")
    kbs = [int(x) for x in os.environ.get("SHINE_CAPS_KB", "32,64").split(",")]
    mode = os.environ.get("SHINE_CAPS_MODE", "auto")
    prerank = _env("SHINE_CAPS_PRERANK", 0)
    emit = Recorder(out, {"family": "split", "n": n, "d": d, "nq": nq, "comp": comp,
                          "mode": mode, "device": str(dev), "card": card_line(dev)})
    recs = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = sync_clock(dev)
    ds = tds.device_rowkeyed_split_dataset(n=n, dim=d, num_queries=nq, seed=SEED,
                                           gt_k=10, comp_dtype=comp, device=dev)
    ingest_s = sync_clock(dev) - t0
    table_gb = (ds.comp_dev.numel() * ds.comp_dev.element_size()
                + ds.aux_dev.numel() * 4) / 1e9
    recs.append(emit({"stage": "ingest", "seconds": ingest_s, "n_rows": ds.n,
                      "table_gb": table_gb, "peak_gb": peak_gb(dev)}))
    queries = np.asarray(ds.queries, np.float32)
    recs += _crosscheck(ds.row_source, queries, emit)
    idx = SplitFlatIndex.from_parts(ds.comp_dev, ds.aux_dev, ds.n, dim=d,
                                    row_source=ds.row_source)
    batch = -(-min(NQ, nq) // 512) * 512  # the search's tq rounds a batch to 512
    pre = idx.preload(queries, batch_size=batch)
    for kb in kbs:
        kw = dict(kb=kb, batch_size=batch, preloaded=pre, with_dists=False,
                  prerank=prerank, **MODES[mode])
        ids, qps = best_qps(lambda: idx.search(queries, 10, **kw), nq, dev)
        knobs = idx._resolve_knobs(kb, MODES[mode].get("cls", 0),
                                   MODES[mode].get("keep2"), None, False)
        recs.append(emit({
            "stage": "search", "kb": kb, "prerank": prerank, "knobs": list(knobs),
            "qps": qps, "recall10": recall_at_k(ids, ds.ground_truth, 10),
            "recall10_eps": recall_at_k_eps_regen(ids, queries, ds.row_source,
                                                  ds.ground_truth, 10),
            "peak_gb": peak_gb(dev)}))
    return recs


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=["routed", "split"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--nq", type=int, default=NQ,
                    help="queries (2048, the JAX scripts' count)")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_routed if args.family == "routed" else run_split
    return run(dev, args.out, args.nq)


if __name__ == "__main__":
    main()
