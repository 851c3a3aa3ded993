#!/usr/bin/env python
"""The HNSW graph at scale on one card: ``fast_build_graph`` over a
device-resident base of 10-16.78M rows, served by the batched search.

The port of the JAX package's ``scripts/scale_10m_hnsw.py`` (the build and
f32 serving), ``scripts/serve_10m_hnsw_quant.py`` (bf16 and int8 rows) and
``scripts/eps_10m_hnsw.py`` (the distance-tolerance recall), in one file:

  1. generate the mixture-of-Gaussians base on the card
     (``io/device_synth.py:device_synthetic_dataset``, seed 29, 2,048
     queries) and its exact f32 top-11;
  2. the margin mask (``margin_mask``, rtol 1e-4) while the base is
     resident;
  3. the scorer crosscheck: the card's top-10 against numpy's on
     SHINE_GT_NEVAL queries (fails at overlap <= 0.995);
  4. ``fast_build_graph(base, HNSWParams(M, ef_construction=pool or 200),
     base_dev=..., stage_path=..., pool=...)``: layer 0 through the fused
     device sweep and select, every stage's seconds, the sweep's memory
     plan, the kernels' launches, the card's peak memory and the host's
     peak resident set; a stale stage file is removed unless resuming; on
     a card, the sweep's class-max scan timed alone at its shape beside its
     bound;
  5. the graph saved under the cache directory (``save_graph``); a later
     run loads it unless SHINE_10MH_REBUILD=1;
  6. for each row kind, ``HNSWIndex(graph, rows=...)`` served at each ef
     with ``SearchParams(k=10, ef=ef, frontier=8)``, batch 2048: recall@10,
     the recall over the margin mask, the distance-tolerance recall
     against the resident base, beam_step's launches in one pass, the
     dense entry's upper vertices U, QPS as the best of two timed passes
     after a warm-up pass; on a card, the first row kind's batch at ef=96
     is timed with CUDA events beside its dense entry alone, then profiled
     (device time by kernel, busy share, beam_step beside its bound).

    python scripts/torch_scale_hnsw.py                       # 10,485,760 x 128, M=16
    SHINE_10MH_N=16777216 SHINE_10MH_M=32 SHINE_10MH_EFS=64,96,128,192,256 \\
        python scripts/torch_scale_hnsw.py                   # the 16.78M point
    SHINE_10MH_N=8192 SHINE_10MH_D=32 SHINE_10MH_M=8 \\
        python scripts/torch_scale_hnsw.py --device cpu --nq 256   # the CPU, tiny

Env (the JAX scripts' knobs): SHINE_10MH_N (10,485,760), SHINE_10MH_D (128),
SHINE_10MH_M (16), SHINE_10MH_EFC (the pool; 0, the scan-speed default),
SHINE_10MH_ROWS ("f32,bf16,int8"), SHINE_10MH_EFS ("64,96,128"),
SHINE_10MH_REBUILD=1 (build even with a checkpoint),
SHINE_10MH_RESUME=1 (keep the stage file: layer 0 loads from it),
SHINE_GT_NEVAL (256). Every record is printed and appended as one JSON line
to ``results/torch_scale_hnsw.jsonl`` (``--out``), with the card's name and
power limit; the checkpoint and stage file go to ``.bench_cache/``
(``--cache``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.config import HNSWParams, SearchParams  # noqa: E402
from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.io import (  # noqa: E402
    gt_crosscheck,
    load_graph,
    margin_mask,
    recall_at_k,
    save_graph,
)
from shine_tpu_torch.io.device_synth import device_synthetic_dataset  # noqa: E402
from shine_tpu_torch.io.recall import recall_at_k_eps  # noqa: E402
from shine_tpu_torch.models import hnsw as th  # noqa: E402
from shine_tpu_torch.models.fastbuild import fast_build_graph  # noqa: E402
from shine_tpu_torch.ops import classmax as cm  # noqa: E402
from shine_tpu_torch.utils.meter import (  # noqa: E402
    PEAK_BYTES,
    Recorder,
    best_qps,
    card_line,
    launches,
    peak_gb,
    reset_launches,
    reset_peak,
    scan_bound,
)
from shine_tpu_torch.utils.timing import sync_clock  # noqa: E402

NQ = 2048
SEED = 29
BATCH = 2048
OUT = os.path.join(ROOT, "results", "torch_scale_hnsw.jsonl")
CACHE = os.path.join(ROOT, ".bench_cache")
MIN_CROSSCHECK = 0.995
PROFILE_EF = 96  # the ef whose batch is timed beside its dense entry


@dataclasses.dataclass
class Config:
    n: int = 10_485_760
    d: int = 128
    M: int = 16
    pool: int = 0
    rows: tuple = ("f32", "bf16", "int8")
    efs: tuple = (64, 96, 128)
    rebuild: bool = False
    resume: bool = False
    gt_neval: int = 256
    nq: int = NQ

    @classmethod
    def from_env(cls, nq: int = NQ) -> "Config":
        env = os.environ.get

        def ints(name: str, default: str) -> tuple:
            return tuple(int(x) for x in env(name, default).split(",") if x)

        return cls(
            n=int(env("SHINE_10MH_N", 10_485_760)), d=int(env("SHINE_10MH_D", 128)),
            M=int(env("SHINE_10MH_M", 16)), pool=int(env("SHINE_10MH_EFC", 0)),
            rows=tuple(x for x in env("SHINE_10MH_ROWS", "f32,bf16,int8").split(",") if x),
            efs=ints("SHINE_10MH_EFS", "64,96,128"),
            rebuild=env("SHINE_10MH_REBUILD") == "1",
            resume=env("SHINE_10MH_RESUME") == "1",
            gt_neval=int(env("SHINE_GT_NEVAL", 256)), nq=nq)

    def paths(self, cache: str) -> tuple[str, str]:
        """(checkpoint, stage file) of this geometry and build."""
        ckpt = os.path.join(cache, f"torch_hnsw_{self.n}x{self.d}_m{self.M}"
                                   f"_efc{self.pool}_s{SEED}.npz")
        return ckpt, ckpt.replace(".npz", "_stage0.npz")


def host_peak_gb() -> float:
    """This process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def make_data(cfg: Config, dev: torch.device, emit) -> tuple:
    """Stages 1-2: the dataset with its exact top-11, and the margin mask."""
    reset_peak(dev)
    t0 = sync_clock(dev)
    # gt_k=11: the 11th column feeds the margin mask
    ds = device_synthetic_dataset(n=cfg.n, dim=cfg.d, num_queries=cfg.nq, seed=SEED,
                                  gt_k=11, device=dev)
    emit({"stage": "gen+gt", "seconds": sync_clock(dev) - t0, "n_rows": ds.n,
          "peak_gb": peak_gb(dev)})
    mm = margin_mask(ds.queries, ds.base_dev, ds.ground_truth, 10, rtol=1e-4)
    emit({"stage": "margin", "margin_frac": float(mm.mean())})
    return ds, mm


def crosscheck(cfg: Config, ds, base: np.ndarray, emit) -> None:
    """Stage 3: the card's exact top-10 against numpy's."""
    t0 = time.perf_counter()
    ov = gt_crosscheck(ds.queries, base, ds.ground_truth, 10, n_eval=cfg.gt_neval)
    emit({"stage": "gt-crosscheck", "gt_overlap": ov, "n_eval": cfg.gt_neval,
          "seconds": time.perf_counter() - t0})
    if ov <= MIN_CROSSCHECK:
        raise SystemExit(f"the card's exact top-10 disagrees with numpy (overlap {ov})")


def build(cfg: Config, ds, base: np.ndarray, stage: str, dev: torch.device, emit):
    """Stage 4: ``fast_build_graph`` with the rows resident; layer 0 loads
    from ``stage`` when it holds this build's layer 0 and the caller
    resumes, else the stale file is removed first."""
    if not cfg.resume and os.path.exists(stage):
        os.remove(stage)
    resumed = cfg.resume and os.path.exists(stage)
    reset_peak(dev)
    reset_launches()
    timings: dict = {}
    t0 = sync_clock(dev)
    graph = fast_build_graph(base, HNSWParams(M=cfg.M, ef_construction=cfg.pool or 200),
                             base_dev=ds.base_dev, stage_path=stage, pool=cfg.pool,
                             timings=timings)
    seconds = sync_clock(dev) - t0
    plan = timings["plan"]
    emit({"stage": "fastbuild", "seconds": seconds, "resumed": resumed,
          # a level of n rows is layer 0: absent when the stage file gave it
          "level0_built": any(lv["n"] == ds.n for lv in timings["levels"]),
          "timings": timings, "launches": launches(), "top_level": int(graph.top_level),
          "upper_vertices": int((graph.levels > 0).sum()), "peak_gb": peak_gb(dev),
          "host_peak_gb": host_peak_gb()})
    if dev.type == "cuda" and plan.get("layout") == "ext":  # the sweep ran on the card
        emit(time_sweep_scan(ds.base_dev, plan))
    return graph


def _profile_batch(index, queries: np.ndarray, sp: SearchParams) -> dict:
    """One batch of ``BATCH`` queries on the card: its dense entry alone and
    the whole batch, each the best of three CUDA-event timings after a
    warm-up; then the batch under torch.profiler: device time by kernel,
    the busy share, and beam_step's time beside its bound, the bytes this
    batch's steps had to read (every layer-0 row scored once, every
    expanded list once) over the card's memory rate."""
    from torch.profiler import ProfilerActivity, profile

    g = index.device_graph
    sp = sp.resolved()
    q = torch.from_numpy(np.ascontiguousarray(queries[:BATCH], np.float32)).to(g.device)
    q_ext, bias = th._extend_query(q, index.metric)
    U = int(g.upper_ids.shape[0])
    m = min(sp.entry_seeds, U)

    def timed(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    entry = timed(lambda: th.dense_entry_positions(q_ext, bias, g.upper_vecs_ext, m, True))
    whole = timed(lambda: th._search(g, q, sp, index.metric))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, hops, dc, _ = th._search(g, q, sp, index.metric)
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    step = [r for r in kernels if "beam_step" in r[0]]
    row_bytes = g.vectors_ext.shape[1] * g.vectors_ext.element_size() + (
        8 if g.row_scl is not None else 0)
    scored = int(dc.sum()) - U * q.shape[0]  # the dense entry's U a query are not steps'
    need = scored * row_bytes + int(hops.sum()) * g.neighbors0.shape[1] * 4
    return {"batch_ms": whole, "entry_ms": entry, "entry_share": entry / whole,
            "profiled_span_ms": span, "busy_ms": busy, "busy_share": busy / span,
            "beam_step_ms": sum(r[1] for r in step), "beam_step_launches": sum(r[2] for r in step),
            "beam_step_bound_ms": need / PEAK_BYTES * 1e3,
            "kernels": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:10]]}


def time_sweep_scan(base_dev: torch.Tensor, plan: dict) -> dict:
    """The build's class-max scan alone at the sweep's shape: one batch of
    ``plan["batch"]`` of the base's own rows against the packed table (the
    ext layout), CUDA events, the median of five after a warm-up; its bound
    the work the function needs (``scan_bound``): the n real rows at width
    d+2, the queries and the class outputs."""
    from shine_tpu_torch.models.flat import FastFlatIndex
    from shine_tpu_torch.ops.scan import pack_ext_query

    idx = FastFlatIndex.from_device(base_dev, shuffle=False)
    B, cls, keep2 = plan["batch"], plan["cls"], plan["keep2"]
    q = pack_ext_query(base_dev[:B], idx.dp).to(torch.bfloat16)
    scan = cm.classmax2_scan if keep2 else cm.classmax_scan
    times = []
    for i in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        scan(idx.ext, q, cls=cls)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    n_pad, dp = idx.ext.shape
    n, width = base_dev.shape[0], base_dev.shape[1] + 2
    bound, by = scan_bound(n, B, width, width * 2, B * cls * (4 if keep2 else 2))
    del idx
    torch.cuda.empty_cache()
    return {"stage": "sweep-scan", "kernel": scan.__name__, "batch": B, "n_pad": n_pad,
            "dp": dp, "cls": cls, "ms": float(np.median(times[1:])), "bound_ms": bound,
            "bound_by": by}


def serve(cfg: Config, graph, ds, mm: np.ndarray, dev: torch.device, emit) -> None:
    """Stage 6: each row kind at each ef."""
    queries, gt = ds.queries, ds.ground_truth
    batch = min(BATCH, cfg.nq)
    for i, rows in enumerate(cfg.rows):
        reset_peak(dev)
        t0 = sync_clock(dev)
        index = th.HNSWIndex(graph, rows=rows, device=dev)
        U = int(index.device_graph.upper_ids.shape[0])
        emit({"stage": "upload", "rows": rows, "seconds": sync_clock(dev) - t0, "U": U,
              "peak_gb": peak_gb(dev)})
        for ef in cfg.efs:
            sp = SearchParams(k=10, ef=ef, frontier=8)
            reset_launches()
            index.search(queries, sp, batch_size=batch)  # the warm-up pass, counted
            passes = launches()
            steps = index.last_steps
            ids, qps = best_qps(lambda: index.search(queries, sp, batch_size=batch),
                                 cfg.nq, dev)
            rec = {"stage": "hnsw", "rows": rows, "ef": ef, "qps": qps,
                   "recall10": recall_at_k(ids, gt, 10),
                   "recall10_margin": recall_at_k(ids[mm], gt[mm], 10),
                   "recall10_eps": recall_at_k_eps(ids, queries, ds.base_dev, gt, 10,
                                                   rtol=1e-4),
                   "launches": passes, "beam_steps": steps, "U": U,
                   "mean_hops": index.last_hops / cfg.nq,
                   "mean_dist_comps": index.last_dists / cfg.nq, "peak_gb": peak_gb(dev)}
            if dev.type == "cuda" and i == 0 and ef == PROFILE_EF:
                rec["profile"] = _profile_batch(index, queries, sp)
            emit(rec)
        del index
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def run(cfg: Config, dev: torch.device, out: str, cache: str = CACHE):
    """Stages 1-6; returns (records, graph)."""
    record = Recorder(out, {"n": cfg.n, "d": cfg.d, "nq": cfg.nq, "M": cfg.M,
                            "pool": cfg.pool, "seed": SEED, "device": str(dev),
                            "card": card_line(dev)})
    recs: list[dict] = []

    def emit(rec: dict) -> dict:
        recs.append(record(rec))
        return recs[-1]

    ds, mm = make_data(cfg, dev, emit)
    ckpt, stage = cfg.paths(cache)
    if os.path.exists(ckpt) and not cfg.rebuild:
        t0 = time.perf_counter()
        graph = load_graph(ckpt)
        emit({"stage": "fastbuild", "seconds": 0.0, "loaded": ckpt,
              "load_seconds": time.perf_counter() - t0})
        crosscheck(cfg, ds, graph.vectors, emit)
    else:
        t0 = time.perf_counter()
        base = ds.base_dev.cpu().numpy()  # the graph's host rows and the numpy witness
        emit({"stage": "base-download", "seconds": time.perf_counter() - t0,
              "gb": base.nbytes / 1e9})
        crosscheck(cfg, ds, base, emit)
        graph = build(cfg, ds, base, stage, dev, emit)
        t0 = time.perf_counter()
        save_graph(graph, ckpt)
        emit({"stage": "checkpoint", "seconds": time.perf_counter() - t0, "path": ckpt,
              "gb": os.path.getsize(ckpt) / 1e9})
    serve(cfg, graph, ds, mm, dev, emit)
    return recs, graph


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--nq", type=int, default=NQ, help="queries (2048, the JAX scripts')")
    ap.add_argument("--out", default=OUT, help="the JSON-lines file appended to")
    ap.add_argument("--cache", default=CACHE, help="where the checkpoint and stage file go")
    args = ap.parse_args(argv)
    recs, _ = run(Config.from_env(args.nq), resolve_device(args.device), args.out, args.cache)
    return recs


if __name__ == "__main__":
    main()
