#!/usr/bin/env python
"""FastFlat and IVF over a card-resident 10M-row base: the port of the JAX
package's ``scripts/scale_10m_validation.py``.

The whole pipeline stays on the card: generation, the exact ground truth,
the index builds and the searches; only queries, ground-truth ids and
result ids visit the host.

  1. ``device_synthetic_dataset(n, d, 2048, seed=17, gt_k=11)`` on the card
     (n rounded up to a multiple of 4096: 10,002,432 rows at 10M), the
     margin mask (rtol 1e-4) and the scorer crosscheck: the card's top-10
     against numpy's on SHINE_GT_NEVAL queries (fails at overlap <= 0.995);
  2. phase ``fastflat``: ``FastFlatIndex.from_device(base)`` at the JAX
     package's defaults (unshuffled above ``SHUFFLE_MAX_BYTES``, as there),
     served at the JAX script's five (kb, cls, keep2) points, batch 2048:
     recall@10, the distance-tolerance and margin recall, QPS as the best of
     two timed passes after a warm-up pass, the kernels' launches in one
     pass; on a card, one batch's class-max scan alone (CUDA events) beside
     its bound, and once per cls the library yardstick, ``torch.matmul`` of
     the bf16 queries against the packed table in 1M-row chunks. Then the
     index built with ``shuffle=True``, served at the first point;
  3. phase ``ivf``: the fine layout ``IVFIndex.from_device(target_cap=1024,
     seed=7, train_size=327,680, iters=20)`` served by ``search`` at probes
     8, 16, 32 (batch 512; on a card, one batch at probes 32 profiled with
     K1's time beside its bound); then the coarse layout (2,048 clusters,
     train_size 262,144) served by ``search_routed`` at three (probes,
     shared, tile) points, batch 2048, with the default spill (0.5): recall,
     coverage, spilled queries, QPS, launches, the step's counted bytes
     (``routed_step_bytes``) beside the card's peak; on a card, one routed
     batch profiled (device time by kernel, busy share).

Every stage records the card's peak allocated memory since its start.
``tq`` is passed as the JAX script passes it and picks no tiling in the port.

    python scripts/torch_scale_validation.py                 # both phases, 10M x 128
    python scripts/torch_scale_validation.py fastflat        # one phase
    SHINE_10M_N=20000 SHINE_10M_D=32 SHINE_10M_FINE_CAP=128 SHINE_10M_COARSE_C=64 \\
        python scripts/torch_scale_validation.py --device cpu --nq 256   # the CPU, tiny

Env: SHINE_10M_N (10,000,000), SHINE_10M_D (128), the JAX script's; and the
IVF builds' knobs, to cut them for small n: SHINE_10M_FINE_CAP (1024),
SHINE_10M_FINE_TRAIN (327,680), SHINE_10M_COARSE_C (2048),
SHINE_10M_COARSE_TRAIN (262,144); SHINE_GT_NEVAL (256). Every record is printed and appended as one JSON line to
``results/torch_scale_validation.jsonl`` (``--out``), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import gt_crosscheck, margin_mask, recall_at_k  # noqa: E402
from shine_tpu_torch.io.device_synth import device_synthetic_dataset  # noqa: E402
from shine_tpu_torch.io.recall import recall_at_k_eps  # noqa: E402
from shine_tpu_torch.models import flat as tflat  # noqa: E402
from shine_tpu_torch.models.ivf import IVFIndex, ivf_stage1, routed_step_bytes  # noqa: E402
from shine_tpu_torch.ops.classmax import top_k  # noqa: E402
from shine_tpu_torch.ops import classmax as cm  # noqa: E402
from shine_tpu_torch.ops.scan import pack_ext_query  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    PEAK_F32,
    Recorder,
    best_qps,
    bound_ms,
    card_line,
    event_ms,
    launches,
    peak_gb,
    profile_once,
    reset_launches,
    reset_peak,
    scan_bound,
)
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

NQ = 2048
SEED = 17
BATCH = 2048
OUT = os.path.join(ROOT, "results", "torch_scale_validation.jsonl")
MIN_CROSSCHECK = 0.995
# the JAX script's FastFlat points: (kb, cls, tq, keep2)
POINTS = ((32, 1024, 512, False), (96, 2048, 512, False), (128, 4096, 256, False),
          (96, 2048, 256, True), (128, 4096, 64, True))
FINE_PROBES = (8, 16, 32)
FINE_BATCH = 512
IVF_SEED = 7
IVF_ITERS = 20  # Lloyd rounds of both IVF builds
ROUTES = ((16, 128, 64), (16, 160, 128), (24, 192, 128))  # (probes, shared, tile)
LIBRARY_CHUNK = 1 << 20  # rows of the packed table a yardstick product


@dataclasses.dataclass
class Config:
    n: int = 10_000_000
    d: int = 128
    phases: tuple = ("fastflat", "ivf")
    fine_cap: int = 1024
    fine_train: int = 327_680
    coarse_c: int = 2048
    coarse_train: int = 262_144
    gt_neval: int = 256
    nq: int = NQ

    @classmethod
    def from_env(cls, phases: tuple = ("fastflat", "ivf"), nq: int = NQ) -> "Config":
        env = os.environ.get
        return cls(
            n=int(env("SHINE_10M_N", 10_000_000)), d=int(env("SHINE_10M_D", 128)),
            phases=tuple(phases), fine_cap=int(env("SHINE_10M_FINE_CAP", 1024)),
            fine_train=int(env("SHINE_10M_FINE_TRAIN", 327_680)),
            coarse_c=int(env("SHINE_10M_COARSE_C", 2048)),
            coarse_train=int(env("SHINE_10M_COARSE_TRAIN", 262_144)),
            gt_neval=int(env("SHINE_GT_NEVAL", 256)), nq=nq)


class Peaks:
    """The card's peak allocated memory, by stage and by phase: ``stage()``
    starts a stage's own count and keeps the phase's largest."""

    def __init__(self, dev: torch.device):
        self.dev, self.most = dev, 0.0

    def stage(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.most = max(self.most, peak_gb(self.dev))
            reset_peak(self.dev)

    def allocated(self) -> float | None:
        """The card's memory allocated now, GB: what a stage holds before
        its own transients."""
        return torch.cuda.memory_allocated(self.dev) / 1e9 if self.dev.type == "cuda" else None

    def phase(self) -> float | None:
        """The phase's peak so far, and a new phase's count from here."""
        if self.dev.type != "cuda":
            return None
        self.stage()
        most, self.most = self.most, 0.0
        return most


def free(dev: torch.device) -> None:
    """Hand the freed blocks of the caching allocator back to the card."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def in_range(ids: np.ndarray, n: int) -> bool:
    """Every returned id a real row: in [0, n)."""
    return bool(ids.size == 0 or (ids.min() >= 0 and ids.max() < n))


def make_data(cfg: Config, dev: torch.device, peaks: Peaks, emit) -> tuple:
    """Stage 1: the dataset with its exact top-11, the margin mask and the
    crosscheck."""
    peaks.stage()
    t0 = sync_clock(dev)
    ds = device_synthetic_dataset(n=cfg.n, dim=cfg.d, num_queries=cfg.nq, seed=SEED,
                                  gt_k=11, device=dev)
    emit({"stage": "gen+gt", "seconds": sync_clock(dev) - t0, "n_rows": ds.n,
          "gb": ds.n * cfg.d * 4 / 1e9, "peak_gb": peak_gb(dev)})
    mm = margin_mask(ds.queries, ds.base_dev, ds.ground_truth, 10, rtol=1e-4)
    emit({"stage": "margin", "margin_frac": float(mm.mean())})
    t0 = time.perf_counter()
    base = ds.base_dev.cpu().numpy()  # numpy's witness
    ov = gt_crosscheck(ds.queries, base, ds.ground_truth, 10, n_eval=cfg.gt_neval)
    del base
    emit({"stage": "gt-crosscheck", "gt_overlap": ov, "n_eval": cfg.gt_neval,
          "seconds": time.perf_counter() - t0})
    if ov <= MIN_CROSSCHECK:
        raise SystemExit(f"the card's exact top-10 disagrees with numpy (overlap {ov})")
    emit({"stage": "data_done", "peak_gb": peaks.phase()})
    return ds, mm


def time_scan(fast, queries: np.ndarray, n: int, cls: int, keep2: bool) -> dict:
    """One batch's class-max scan alone at this point's form (the search's
    unfused K2a or K2b: kb is above the fused forms' limit at every JAX
    point), CUDA events, beside its bound: the n real rows at width d+2,
    the bf16 queries and the class outputs."""
    q = pack_ext_query(torch.from_numpy(queries[:BATCH]).to(fast.device),
                       fast.dp).to(torch.bfloat16)
    scan = cm.classmax2_scan if keep2 else cm.classmax_scan
    ms = event_ms(lambda: scan(fast.ext, q, cls=cls))
    width = fast.dim + 2
    B = q.shape[0]
    bound, by = scan_bound(n, B, width, width * 2, B * cls * (4 if keep2 else 2))
    return {"kernel": scan.__name__, "ms": ms, "bound_ms": bound, "bound_by": by,
            "x_bound": ms / bound}


def library_ms(fast, queries: np.ndarray) -> float:
    """The yardstick: ``torch.matmul`` of the bf16 packed queries against the
    packed table in LIBRARY_CHUNK-row chunks, summed (no class max); used
    nowhere in the port."""
    q = pack_ext_query(torch.from_numpy(queries[:BATCH]).to(fast.device),
                       fast.dp).to(torch.bfloat16)
    ext = fast.ext

    def product():
        for lo in range(0, ext.shape[0], LIBRARY_CHUNK):
            torch.matmul(q, ext[lo:lo + LIBRARY_CHUNK].T)

    return event_ms(product)


def serve_fastflat(fast, ds, mm, dev, peaks: Peaks, emit, point, *, index: str,
                   yardstick: float | None = None) -> dict:
    """One FastFlat point: launches in one pass, then QPS and recall."""
    kb, cls, tq, keep2 = point
    queries, gt = ds.queries, ds.ground_truth
    batch = max(tq, -(-min(BATCH, len(queries)) // tq) * tq)  # the search's own rule
    pre = fast.preload(queries, batch_size=batch)
    kw = dict(batch_size=batch, tq=tq, kb=kb, cls=cls, preloaded=pre, with_dists=False,
              keep2=keep2)
    peaks.stage()
    reset_launches()
    fast.search(queries, 10, **kw)
    passes = launches()
    ids, qps = best_qps(lambda: fast.search(queries, 10, **kw), len(queries), dev)
    rec = {"stage": "fastflat", "index": index, "kb": kb, "cls": cls, "tq": tq,
           "keep2": keep2, "qps": qps, "recall10": recall_at_k(ids, gt, 10),
           "recall10_eps": recall_at_k_eps(ids, queries, ds.base_dev, gt, 10, rtol=1e-4),
           "recall10_margin": recall_at_k(ids[mm], gt[mm], 10),
           "ids_in_range": in_range(ids, ds.n), "launches": passes,
           "peak_gb": peak_gb(dev)}
    if dev.type == "cuda":
        rec["scan"] = time_scan(fast, queries, ds.n, cls, keep2)
        rec["library_ms"] = yardstick
    return emit(rec)


def phase_fastflat(cfg: Config, ds, mm, dev, peaks: Peaks, emit) -> None:
    """The default index at the five points, the shuffled one at the first."""
    t_phase = sync_clock(dev)
    peaks.stage()
    fast = tflat.FastFlatIndex.from_device(ds.base_dev)
    emit({"stage": "fastflat_build", "index": "default", "seconds": sync_clock(dev) - t_phase,
          "shuffled": fast.perm is not None, "rows_bytes": ds.n * cfg.d * 4,
          "shuffle_max_bytes": tflat.SHUFFLE_MAX_BYTES, "n_pad": int(fast.ext.shape[0]),
          "dp": fast.dp, "peak_gb": peak_gb(dev)})
    yardsticks: dict[int, float] = {}  # by cls, timed at its first point
    for point in POINTS:
        cls = point[1]
        if dev.type == "cuda" and cls not in yardsticks:
            yardsticks[cls] = library_ms(fast, ds.queries)
        serve_fastflat(fast, ds, mm, dev, peaks, emit, point, index="default",
                       yardstick=yardsticks.get(cls))
    del fast
    free(dev)
    peaks.stage()
    t0 = sync_clock(dev)
    shuffled = tflat.FastFlatIndex.from_device(ds.base_dev, shuffle=True)
    emit({"stage": "fastflat_build", "index": "shuffled", "seconds": sync_clock(dev) - t0,
          "shuffled": True, "peak_gb": peak_gb(dev)})
    serve_fastflat(shuffled, ds, mm, dev, peaks, emit, POINTS[0], index="shuffled")
    del shuffled  # its f32 copy of the rows: gone before the IVF phase
    free(dev)
    emit({"stage": "fastflat_done", "seconds": sync_clock(dev) - t_phase,
          "peak_gb": peaks.phase()})


def k1_work(ivf: IVFIndex, queries: np.ndarray, p: int, rerank: int = 4) -> dict:
    """K1's least time in one ``search`` batch of ``queries``: its two
    launches, the probed rows' products (every probed cluster's rows read
    once, the (query, row) ids read and the products written) and the
    re-rank's (rerank * 10 f32 rows a query), f32 products at the fp32
    peak; bytes or operations, whichever takes longer."""
    data = ivf.data
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(ivf.device)
    B, d = q.shape
    probes = top_k(-ivf_stage1(data, q, metric=ivf.metric), p)[1]
    uniq = int(torch.unique(probes).numel())
    pairs, kk = B * p * data.cap, rerank * 10
    nbytes = (uniq * data.cap * d * 2 + pairs * 8 + B * d * 4
              + B * kk * (d * 4 + 8))
    ms, by = bound_ms(nbytes, 2.0 * d * (pairs + B * kk), PEAK_F32)
    return {"clusters_read": uniq, "pairs": pairs, "bound_ms": ms, "bound_by": by}


def _ivf_build(ds, dev, peaks: Peaks, emit, stage: str, **kw) -> IVFIndex:
    peaks.stage()
    timings: dict = {}
    t0 = sync_clock(dev)
    ivf = IVFIndex.from_device(ds.base_dev, seed=IVF_SEED, device=dev, timings=timings, **kw)
    emit({"stage": stage, "seconds": sync_clock(dev) - t0, "timings": timings,
          "clusters": ivf.data.num_clusters, "cap": ivf.data.cap, **kw,
          "peak_gb": peak_gb(dev)})
    return ivf


def phase_ivf(cfg: Config, ds, mm, dev, peaks: Peaks, emit) -> None:
    """The fine layout by ``search``, then the coarse one by ``search_routed``."""
    queries, gt = ds.queries, ds.ground_truth
    t_phase = sync_clock(dev)

    def quality(ids: np.ndarray) -> dict:
        return {"recall10": recall_at_k(ids, gt, 10),
                "recall10_eps": recall_at_k_eps(ids, queries, ds.base_dev, gt, 10,
                                                rtol=1e-4),
                "recall10_margin": recall_at_k(ids[mm], gt[mm], 10),
                "ids_in_range": in_range(ids, ds.n)}

    ivf = _ivf_build(ds, dev, peaks, emit, "ivf_build", target_cap=cfg.fine_cap,
                     train_size=cfg.fine_train, iters=IVF_ITERS)
    for p in FINE_PROBES:
        peaks.stage()
        reset_launches()
        ivf.search(queries, 10, probes=p, batch_size=FINE_BATCH)
        passes = launches()
        ids, qps = best_qps(lambda: ivf.search(queries, 10, probes=p,
                                               batch_size=FINE_BATCH), len(queries), dev)
        rec = {"stage": "ivf", "probes": p, "batch": FINE_BATCH, "qps": qps, **quality(ids),
               "launches": passes, "peak_gb": peak_gb(dev)}
        if dev.type == "cuda" and p == FINE_PROBES[-1]:
            # one batch: K1's device time beside its bound
            one = queries[:FINE_BATCH]
            prof = profile_once(lambda: ivf.search(one, 10, probes=p, batch_size=FINE_BATCH))
            k1 = k1_work(ivf, one, p)
            k1["ms"] = sum(k["ms"] for k in prof["kernels"] if "gather_score" in k["name"])
            rec.update(profile=prof, k1=k1)
        emit(rec)
    del ivf
    free(dev)
    ivf = _ivf_build(ds, dev, peaks, emit, "ivf_coarse_build", num_clusters=cfg.coarse_c,
                     train_size=cfg.coarse_train, iters=IVF_ITERS)
    batch = min(BATCH, len(queries))
    pre = ivf.preload(queries, batch_size=batch)
    C, cap, d = ivf.data.num_clusters, ivf.data.cap, ivf.data.vectors.shape[1]
    for i, (p, shared, tile) in enumerate(ROUTES):
        stats: dict = {}

        def routed():
            ids, dists, st = ivf.search_routed(queries, 10, probes=p, shared=shared,
                                               tile=tile, batch_size=batch, preloaded=pre,
                                               with_stats=True)
            stats.update(st)
            return ids, dists

        peaks.stage()
        resident = peaks.allocated()
        reset_launches()
        routed()
        passes = launches()
        ids, qps = best_qps(routed, len(queries), dev)
        rec = {"stage": "ivf_routed", "probes": p, "shared": shared, "tile": tile,
               "batch": batch, "qps": qps, **quality(ids),
               "coverage": stats["probe_coverage"],
               "fallback_queries": stats["fallback_queries"], "launches": passes,
               "step_gb": routed_step_bytes(min(shared, C), cap, d, tile) / 1e9,
               "resident_gb": resident, "peak_gb": peak_gb(dev)}
        if dev.type == "cuda" and i == 0:
            one = ivf.preload(queries[:BATCH], batch_size=BATCH)
            rec["profile"] = profile_once(lambda: ivf.search_routed(
                queries[:BATCH], 10, probes=p, shared=shared, tile=tile, batch_size=BATCH,
                preloaded=one))
        emit(rec)
    del ivf, pre
    free(dev)
    emit({"stage": "ivf_done", "seconds": sync_clock(dev) - t_phase,
          "peak_gb": peaks.phase()})


PHASES = {"fastflat": phase_fastflat, "ivf": phase_ivf}


def run(cfg: Config, dev: torch.device, out: str):
    """Stage 1, then each phase of ``cfg.phases``; returns (records, dataset)."""
    unknown = set(cfg.phases) - set(PHASES)
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)} (use {sorted(PHASES)})")
    record = Recorder(out, {"n": cfg.n, "d": cfg.d, "nq": cfg.nq, "seed": SEED,
                            "device": str(dev), "card": card_line(dev)})
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    peaks = Peaks(dev)
    ds, mm = make_data(cfg, dev, peaks, emit)
    for name in cfg.phases:
        PHASES[name](cfg, ds, mm, dev, peaks, emit)
    return recs, ds


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", default=["fastflat", "ivf"],
                    help="fastflat, ivf or both (the default)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--nq", type=int, default=NQ, help="queries (2048, the JAX script's)")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    args = ap.parse_args(argv)
    recs, _ = run(Config.from_env(tuple(args.phases), args.nq),
                  resolve_device(args.device), args.out)
    return recs


if __name__ == "__main__":
    main()
