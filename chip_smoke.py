"""Run the PyTorch port's main paths once on a CUDA card, and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and scipy; builds everything from this checkout
into build/ (the CUDA kernels, one nvcc per source, all at once, beside
the native graph builder's g++). Phases, on one SIFT1M-shaped synthetic
set (1M x 128, 10,000 queries, L2, seed 7), generated once:

  1. device: the card's name and power limit; the fp32 precision lock;
  2. build: compile and load the kernel library and the native builder;
  3. K1's gather_score against its plain twin on the HNSW slice's shapes
     (B=4096 queries, K=256 candidate lanes, d=128, N=1M rows) for f32,
     bf16 and int8 rows under L2 and IP, ~10% masked lanes;
  4. K2 against its plain twins: the four class-max forms on the packed
     table (1,003,520 x 144 bf16) of the set, B=4096, L2 and IP, at the
     (cls, kb) that each FastFlatIndex route of phase 7 resolves to, and
     at cls=2048/kb=64 and cls=1024/kb=32; each fused select against the
     unfused form plus select_lanes, bit for bit; CUDA-event timings of
     kernels, twins and the bare bf16 product (torch.matmul, the
     yardstick the port never calls);
  5. HNSW: the native build at M=16, ef_construction=200, search with
     k=10, ef=96, frontier=8 at batch 4096 on f32 rows, then bf16 rows,
     after a warm-up pass, every layer-0 step one launch of K1's fused
     beam_step; recall@10 against an exact fp32 brute force on the card;
  6. HNSW end to end: 256 queries on the CPU (twins) and the card;
  7. FastFlatIndex: all queries at batch 4096 through each of the four
     scan routes (the auto knobs, bench's keep2 point, keep2 at kb=64,
     kb=16), recall@10 against the same ground truth, QPS after a
     warm-up batch, each kernel's launches;
  8. FastFlatIndex end to end: 256 queries on the CPU and the card, at
     the auto knobs and the keep2 point;
     A profile of one auto batch (device time by kernel, busy share)
     follows phases 7 and 10;
  9. K3 against its plain twins: both split functions, keep1 and keep2, on
     the set's bf16 and int8 split tables (1,015,808 x 128, aux
     (2, 1,015,808)), B=4096, L2 and IP, at the (cls, kb) that each
     SplitFlatIndex route of phase 10 resolves to and at cls=4096/kb=32;
     each fused form against the unfused form plus select_lanes, bit for
     bit; CUDA-event timings of kernels, twins and the bare bf16 product
     (for int8, on the table widened to bf16 before the timing);
 10. SplitFlatIndex, bf16 and int8: all queries at batch 4096 through four
     routes (the auto knobs, keep2 at kb=32, keep2 at kb=64, kb=16),
     recall@10, QPS after a warm-up batch, each K3 form's launches;
 11. SplitFlatIndex end to end: 256 queries on the CPU and the card at the
     auto knobs, bf16 and int8.

Phase 19 runs between phases 5 and 6, on phase 5's graph:

 19. K1's beam_step against beam_step_ref, bit for bit after every step of
     whole searches of 512 queries, for f32, bf16 and int8 rows; one
     mid-search step at B=4096 timed with CUDA events for each row type,
     with the share of lanes that hold an id and the share of those kept
     after the duplicate drop, and the step's bound; a profile of one f32
     batch; the descent entry (entry_mode="descent"), whose greedy walk
     and first distance score through gather_score, served once.

Phases 14-18 (run between phases 8 and 9, on the same set) port the
scan-speed graph build and the block-max scans:

 14. K5 and K6 against their plain twins on FastFlat's packed table
     (1,003,520 x 144, 3,520 pad rows), B=4096, L2 and IP: bit for bit on
     an integer table of that shape (ties inside and across blocks), to a
     stated tolerance on the set's rows; CUDA-event timings of the kernels,
     the twins and the bare bf16 product;
 15. FastFlatIndex through the block-max route (K5, what the JAX package
     runs under interpret): all queries at batch 4096 and the auto kb,
     recall@10, QPS after a warm-up batch, K5's launches; then 256 queries
     on the CPU (twins) and the card;
 16. fast_build_graph on the card, the rows resident (M=16): pool 0 (k=32,
     keep2 at cls=1024, K2b) and pool 200 (ef_construction parity), each
     build's stage times, sweep plan and launches, each graph served as in
     phase 5 (f32 rows) beside the native graph;
 17. the same build through the block-max sweep (K5), its recall within
     0.01 of the pool-0 graph's;
 18. the build at 8192 x 16 on the CPU (twins) and on the card: equal levels
     and entry point, overlapping layer-0 lists, the same recall.

Phases 20 and 21 (run after phase 18, on the same set) port the insert
build and the online index:

 20. device_build_graph on the card at its defaults (batch 512, first
     batch 32, level cap 12) and M=16, ef_construction=200: the wall and
     CUDA-synchronised seconds of each stage of its rounds (the descent,
     the upper-level searches, the layer-0 search, the select, the own
     rows, the reverse edges, the re-prune), its rounds, inserts/s and
     beam_step and gather_score launches; its graph validated and served as
     in phase 5 (f32 rows), recall@10 within 0.02 of the native graph's;
     two builds of the first 65,536 rows bit-identical; a 4096 x 16
     integer build equal on the CPU (twins) and on the card;
 21. DynamicHNSWIndex(128, capacity=262,144) fed the set's first 262,144
     rows in four chunks: each chunk's inserts/s and launches, then its
     searcher's recall@10 against the exact top-10 of the inserted prefix;
     after the second chunk, the build's searches on the index's state,
     seeded by the greedy descent (ef=200, frontier=4): layer 0 for the
     next 512 rows over neighbors0, and level 1 for their upper sub-batch
     (136 slots) over the (N, 16) level-1 list table; on each, beam_step
     against beam_step_ref bit for bit after every step, and step 8 timed
     with its bound.

Phase 22 (after phase 11, on the same set) runs the command line,
``shine_tpu_torch.cli.main`` in this process with its output captured, from
phase 5's native graph (saved with ``save_graph`` before phase 6) and the set
with its exact top-10 (saved with ``save_dataset`` after phase 11), both in
a temporary directory under build/ that the phase removes; every run with
``-k 10 --batch 4096``, one [cli] line each (build ms, QPS, recall, the
counters, each kernel's launches) and its QPS beside the library call's at
the same knobs:

 22. --index hnsw --load-index (phase 5's build and search knobs): phase 5's
     f32 recall exactly, beam_step launched; --index hnsw --fast-build: phase
     16's pool-0 recall exactly, K2b launched; --index fastflat: phase 7's
     auto-route recall exactly, K2a launched; --index split (int8) and
     --index routed --probes 0: recall >= 0.90, K3 and K4 launched; --index
     auto --zipf 1.0 --warmup 1000: resolves to fastflat, recall >= 0.98;
     --index flat --num-queries 1000: the recall of FlatIndex.search on the
     same queries; then --synthetic 65536:128 --num-queries 1000 --index hnsw
     --device-build: recall >= 0.90, beam_step and gather_score launched;
     --index ivf --probes 32 --seed 1234 and --index ivf --ivf-routed --seed
     1234: the recall of phase 23's library call at the same seed and knobs
     exactly, no kernel launched.

Phase 23 (after phase 11, before phase 22, on the same set) ports the IVF
family; IVF launches no kernel of the table (its products are torch, as
the JAX package's are XLA):

 23. IVFIndex(base, seed=1234) built on the host (C=7,813, cap 160), its
     stage seconds (k-means, choices, capacity assignment, fill, upload) and
     layout invariants (every id once, no cluster over cap, pads -1, +inf,
     zero rows); search at probes 16, 32 and 64, batch 4096, recall@10
     (never falling as probes rise) and QPS after a warm-up batch; 256
     queries on a CPU copy of the layout against the card (id overlap >=
     0.99); probe_chunk=4 bit for bit with the default on one batch of
     4096 (ivf_search); search_routed on
     this layout at the command line's knobs (what --ivf-routed serves);
     a profile of one probes-32 batch; full probes over the set's first
     65,536 rows in 512 clusters (recall@10 >= 0.99 against their exact
     top-10, 1,000 queries, rerank 8); the routed layout (C=2,048, cap 611)
     served by search_routed at the command line's knobs and bench.py's
     (probes 16, shared 128, tile 64) with coverage and spilled queries, a
     profile of one batch, and fallback=1.1 equal to search at probes 16,
     id for id; IVFIndex.from_device on the card-resident base with its
     stage seconds, the same invariants, recall@10 at probes 32 within 0.02
     of the host build's. One [ivf] summary line.

Phases 12 and 13 run on a second set, 4,194,304 x 128 (10,000 queries, L2,
seed 7), the JAX package's smallest measured routed operating point, with
exact ground truth on the card:

 12. RoutedSplitIndex: the clustered build on the card from the raw rows at
     the command line's defaults (cap_target=4096, cls=1024, int8, slack
     1.05, assign_r=8, seed 1234; the base stays resident), its stage
     times and assignment-rank histogram; all queries at batch 4096 on
     three routes (the auto knobs: probes=32, T=64, shared=192, kk=80,
     fallback 0.5; tile=32; a starved grant, shared=32, whose fallback
     spill runs T=16 tiles), recall@10, QPS after a warm-up batch,
     coverage, the spill and K4's launches by form; a one-batch profile
     at the auto knobs; then 256 queries on the CPU (twins) and the card;
     then a second build of the same seed, which must place every row as
     the first did (ROADMAP C9: equal r0, centroids and layout, the same
     starved spill);
 13. K4 against its plain twin at each route's own inputs (the auto and
     tile=32 routes' first batch, the starved route's spill batch), on
     the index's int8 table and a bf16 table packed in the same order,
     L2 and IP; CUDA-event timings of the kernel, the twin and a bf16
     torch.bmm of each group's queries against its gathered blocks (the
     yardstick, gather untimed, never called by the port).

Every count of kernel launches is set to 0 just before the run it reads.
Each kernel's entry in the JSON table pairs those launches with the time,
error and bound taken at the shape its route ran. Any failure raises. On
success the last line is
{"ok": true, "device": {"platform": "gpu", ...}}; the line before it holds
nvidia-smi's name and power limit, and the one before that the kernel
table as JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from shine_tpu_torch import (
    DynamicHNSWIndex,
    FastFlatIndex,
    FlatIndex,
    HNSWIndex,
    IVFIndex,
    RoutedSplitIndex,
    SplitFlatIndex,
    build_routed_split,
    cli,
    device_build_graph,
    native,
)
from shine_tpu_torch.config import METRIC_IP, METRIC_L2, HNSWParams, SearchParams
from shine_tpu_torch.graph.soa import build_graph
from shine_tpu_torch.io import recall_at_k, save_dataset, save_graph, synthetic_dataset
from shine_tpu_torch.models import routed_split as rs
from shine_tpu_torch.models.ivf import IVFData, ivf_search
from shine_tpu_torch.models.fastbuild import fast_build_graph
from shine_tpu_torch.models import build as tb
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.models.hnsw import _extend_query, quantize_rows
from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops import blockmax as bm
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops import scan_routed as k4
from shine_tpu_torch.ops import beam_step as bs
from shine_tpu_torch.ops.beam import Beam
from shine_tpu_torch.ops.distance import check_precision, exact_knn, squared_norms
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table
from shine_tpu_torch.ops.scan_split import (
    SPLIT_QUANTUM,
    pack_split_query,
    pack_split_tables,
)

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
B, K = 4096, 256  # bench batch; E * 2M = 8 * 32 candidate lanes per step
BUILD = HNSWParams(M=16, ef_construction=200)
SEARCH = SearchParams(k=10, ef=96, frontier=8)
RTOL, ATOL = 1e-5, 1e-3  # distances are O(1e3); the two sum in other orders
# FastFlat's L2 distances (down to ~10) are differences of terms up to ~8e3
# (|q|^2, 2<q, v>, |v|^2) whose f32 ulp is 9.8e-4; the two devices sum them
# in other orders
FLAT_ATOL = 4e-3
MIN_RECALL = 0.90
E2E_QUERIES, MIN_OVERLAP = 256, 0.99
# K2 scores sum 144 bf16 products (each exact in f32) whose magnitudes add
# up to ~6.6e3 at most on this set: two f32 sums in other orders differ by
# at most 144 * 2^-23 * 6.6e3 = 0.11, so 0.25 is twice the worst case
K2_ATOL = 0.25
K2_SHAPES = ((2048, 64), (1024, 32))  # (cls, kb), checked beside the routes'
FLAT_MIN_RECALL = 0.98  # the JAX package read 0.9914-1.0000 on this shape
FLAT_ROUTE_MIN_RECALL = 0.90  # the two extra routes: broken, not mistuned
# H100 SXM data sheet: HBM bytes/s, dense bf16 and fp32 (CUDA core) FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# the FastFlatIndex routes (name, search knobs): between them they launch
# every K2 form, each form on one route (flat_route_plan checks it)
FLAT_ROUTES = (
    ("auto", {}),
    ("keep2_point", {"tq": 256, "kb": 32, "keep2": True}),
    ("keep2_kb64", {"kb": 64, "keep2": True}),
    ("kb16", {"kb": 16}),
)
K2_FORMS = {
    "classmax_scan": (cm.classmax_scan, cm.classmax_scan_ref,
                      "shine_tpu/ops/pallas_scan3.py:209"),
    "classmax2_scan": (cm.classmax2_scan, cm.classmax2_scan_ref,
                       "shine_tpu/ops/pallas_scan3.py:170"),
    "classmax_topk_scan": (cm.classmax_topk_scan, cm.classmax_topk_scan_ref,
                           "shine_tpu/ops/pallas_scan3.py:411"),
    "classmax2_topk_scan": (cm.classmax2_topk_scan, cm.classmax2_topk_scan_ref,
                            "shine_tpu/ops/pallas_scan3.py:447"),
}


# K3 scores: 2<q, v> - ||v||^2 (or scl * <q, comp> + nrm for int8) from 128
# bf16 products, each exact in f32, summed in another order than the twin's
# f32 matmul: at most 128 * 2^-23 * sum|products| * scl, under 0.1 on this
# set; 0.25 as for K2
K3_ATOL = 0.25
SPLIT_DTYPES = ("bf16", "int8")
K3_EXTRA_SHAPE = (4096, 32)  # (cls, kb) the auto rule takes past 1,024,000 rows
SPLIT_MIN_RECALL = 0.98  # bf16 at the auto knobs: the floor FastFlat holds here
# the SplitFlatIndex routes: between them they launch every K3 form
SPLIT_ROUTES = (
    ("auto", {}),
    ("keep2_kb32", {"kb": 32, "keep2": True}),
    ("keep2_kb64", {"kb": 64, "keep2": True}),
    ("kb16", {"kb": 16}),
)
K3_FUNCS = {
    "classmax_scan_split": (cm.classmax_scan_split, cm.classmax_scan_split_ref,
                            "shine_tpu/ops/pallas_scan_split.py:176"),
    "classmax_topk_scan_split": (cm.classmax_topk_scan_split,
                                 cm.classmax_topk_scan_split_ref,
                                 "shine_tpu/ops/pallas_scan_split.py:267"),
}


# the routed set and build: the JAX package's 4.19M operating point
# (models/routed_split.py:_auto_probes) at the command line's defaults
# (shine_tpu/cli.py:368-372)
RN = 4_194_304
ROUTED_BUILD = dict(cap_target=4096, cls=1024, comp_dtype="int8", cap_slack=1.05,
                    assign_r=8, seed=1234)
# the RoutedSplitIndex routes: the auto knobs (T=64), tile=32 (T=32), and a
# starved grant whose fallback spill runs T=16 tiles
ROUTED_ROUTES = (
    ("auto", {}),
    ("tile32", {"tile": 32}),
    ("starved", {"shared": 32}),
)
ROUTED_MIN_RECALL = 0.90
# K4's scores are K3's (scl * <q, comp> + nrm from 128 bf16 products on the
# same kind of rows), summed in another order than the twin's: K3's bound
K4_ATOL = K3_ATOL


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches() -> None:
    gather_score.launches = 0
    bs.beam_step.launches = 0
    bm.blockmax_scan.launches = 0
    bm.blockmax_scan2.launches = 0
    for fn, _, _ in K2_FORMS.values():
        fn.launches = 0
    for fn, _, _ in K3_FUNCS.values():
        fn.launches = 0
        fn.form_launches.clear()
    k4.routed_classmax_scan.launches = 0
    k4.routed_classmax_scan.form_launches.clear()


def kernel_vs_twin(base: np.ndarray, queries: np.ndarray, dev) -> list[dict]:
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, base.shape[0], size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    ids_t = torch.from_numpy(ids).to(dev)
    masked = ids_t < 0
    q = torch.from_numpy(queries[:B]).to(dev)
    cases = []
    for rows in ("f32", "bf16", "int8"):
        tables = {k: v.to(dev) for k, v in quantize_rows(base, rows).items()}
        vectors = tables.pop("vectors_ext")
        for metric, l2 in (("l2", True), ("ip", False)):
            q_ext, bias = _extend_query(q, 0 if l2 else 1)
            kw = dict(tables, l2=l2)
            if not l2:
                kw.pop("row_nrm", None)
            out = gather_score(vectors, q_ext, bias, ids_t, **kw)
            torch.cuda.synchronize()
            ref = gather_score_ref(vectors, q_ext, bias, ids_t, **kw)
            if not torch.equal(torch.isinf(out), masked):
                raise AssertionError(f"{rows}/{metric}: inf not exactly where id<0")
            err = float((out[~masked] - ref[~masked]).abs().max())
            if not torch.allclose(out[~masked], ref[~masked], rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{rows}/{metric}: kernel disagrees, max err {err}")
            ms = cuda_ms(lambda: gather_score(vectors, q_ext, bias, ids_t, **kw))
            plain_ms = cuda_ms(
                lambda: gather_score_ref(vectors, q_ext, bias, ids_t, **kw))
            # each valid row read once; ids, queries, bias, scales, output
            row_bytes = vectors.element_size() * D + (8 if rows == "int8" else 0)
            nbytes = (int((~masked).sum()) * row_bytes + B * K * 8
                      + B * (D + 1) * 4)
            flops = 4.0 * int((~masked).sum()) * D  # dot and square-sum
            bms, by = bound_ms(nbytes, flops, PEAK_F32)
            cases.append(dict(rows=rows, metric=metric, max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by))
            log(f"[K1] {rows:4s} {metric}: max_abs_err={err:.3e} kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del vectors, tables
    return cases


def flat_route_plan(index: FastFlatIndex) -> list[tuple]:
    """(route, knobs, kernel, cls, kb) of each FastFlatIndex route, from the
    index's own knob resolution; fails unless the routes launch every K2
    form, each on one route."""
    plan = []
    for route, knobs in FLAT_ROUTES:
        kb, cls, keep2, fused = index._resolve_knobs(
            knobs.get("kb", 0), 0, knobs.get("keep2"), None, False)
        kernel = (("classmax2" if keep2 else "classmax")
                  + ("_topk" if fused else "") + "_scan")
        plan.append((route, knobs, kernel, cls, min(kb, cls)))
    if sorted(p[2] for p in plan) != sorted(K2_FORMS):
        raise AssertionError(f"the routes launch {[p[2] for p in plan]}, not "
                             "each K2 form once")
    return plan


def _k2_bound(name: str, cls: int, kb: int | None) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D+2 (the
    port's zero columns and pad rows add none), B queries, the outputs."""
    width = D + 2
    planes = 4 if name.startswith("classmax2") else 2
    nbytes = (N * width * 2 + B * width * 2
              + B * (cls if kb is None else kb) * 4 * planes)
    return bound_ms(nbytes, 2.0 * B * N * width, PEAK_BF16)


def _k2_err(got, want, cls: int) -> float:
    """Largest score difference of a form's outputs against its twin's.
    Where two classes' best scores lie within K2_ATOL the kernel may order
    them otherwise than the twin, so a fused form's runner-ups are compared
    only where both picked the same lane (row % cls) at that position."""
    err = float((got[0] - want[0]).abs().max())
    if len(got) == 4:
        same = (got[1] % cls) == (want[1] % cls)
        err = max(err, float((got[2] - want[2])[same].abs().max()))
    return err


def _check_rescored(ext, q, planes, name: str) -> None:
    """Each selected row, scored again in f32 from the table, has the
    score reported beside it (runner-ups that never entered excepted)."""
    qf = q.float()
    for s, r in zip(planes[::2], planes[1::2]):
        rescored = torch.einsum("bd,bkd->bk", qf, ext[r.long()].float())
        real = s > -3e38
        err = float((rescored - s)[real].abs().max())
        if err > K2_ATOL:
            raise AssertionError(f"{name}: a selected row scores {err} away "
                                 "from its reported score")


def _k2_form(name, ext, q, metric: str, cls: int, kb: int | None,
             cases: dict[str, list]) -> tuple:
    """One form at one shape against its twin; times it under L2 and
    records the case. Returns the kernel's outputs."""
    fn, ref, _ = K2_FORMS[name]
    kw = {"cls": cls} if kb is None else {"cls": cls, "kb": kb}
    got = fn(ext, q, **kw)
    torch.cuda.synchronize()
    err = _k2_err(got, ref(ext, q, **kw), cls)
    if err > K2_ATOL:
        raise AssertionError(f"{name} {metric} cls={cls} kb={kb}: scores "
                             f"differ by {err} > {K2_ATOL}")
    case = {"metric": metric, "cls": cls, "kb": kb, "max_abs_err": err}
    msg = f"[K2] {name} {metric} cls={cls} kb={kb}: max_abs_err={err:.3e}"
    if metric == "l2":  # time the slice's own metric
        case["ms"] = cuda_ms(lambda: fn(ext, q, **kw), reps=10)
        case["plain_ms"] = cuda_ms(lambda: ref(ext, q, **kw), reps=3, warmup=1)
        case["bound_ms"], case["bound_by"] = _k2_bound(name, cls, kb)
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} "
                f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
    cases[name].append(case)
    log(msg)
    return got


def k2_vs_twin(base: np.ndarray, queries: np.ndarray, dev,
               shapes: dict[int, list[int]]) -> tuple[dict[str, list], float]:
    """All four K2 forms against their twins on the set's packed tables:
    the unfused forms at each cls of ``shapes``, the fused forms at each
    of its (cls, kb). Returns each form's cases and the yardstick's ms."""
    n_pad = -(-N // QUANTUM) * QUANTUM
    cases: dict[str, list] = {name: [] for name in K2_FORMS}
    library_ms = None
    for metric, mid in (("l2", 0), ("ip", 1)):
        ext = pack_ext_table(base, mid, n_pad, device=dev)
        dp = ext.shape[1]
        q = pack_ext_query(torch.from_numpy(queries[:B]).to(dev), dp).to(
            torch.bfloat16)
        for cls, kbs in shapes.items():
            lane = torch.arange(cls, device=dev, dtype=torch.int32)
            t1, tr1, t2, _ = cm.classmax2_scan_ref(ext, q, cls=cls)
            clear = (t1 - t2) > K2_ATOL  # the twin's winner is unambiguous
            unfused = {}
            for name in ("classmax_scan", "classmax2_scan"):
                got = _k2_form(name, ext, q, metric, cls, None, cases)
                if not torch.equal(got[1] % cls, lane.expand_as(got[1])):
                    raise AssertionError(f"{name}: a row outside its class")
                if not torch.equal(got[1][clear], tr1[clear]):
                    raise AssertionError(f"{name} {metric} cls={cls}: rows "
                                         "differ where the winner is clear")
                unfused[name] = got
            for kb in kbs:
                for name in ("classmax_topk_scan", "classmax2_topk_scan"):
                    got = _k2_form(name, ext, q, metric, cls, kb, cases)
                    _check_rescored(ext, q, got, name)
                    # the fused select == unfused form + select, bit for bit
                    base_form = unfused[name.replace("_topk", "")]
                    vals, sel = cm.select_lanes(base_form[0], kb)
                    expect = (vals,) + tuple(torch.gather(p, 1, sel)
                                             for p in base_form[1:])
                    if not all(torch.equal(g, e) for g, e in zip(got, expect)):
                        raise AssertionError(f"{name} {metric} cls={cls} kb="
                                             f"{kb}: the fused select is not "
                                             "the unfused form plus select")
            del t1, tr1, t2, clear, unfused
        if metric == "l2":
            # the yardstick: the bare bf16 product in 65,536-row chunks
            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, ext[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K2] torch.matmul bf16 ({B}, {dp}) x ({n_pad}, {dp})^T in "
                f"65,536-row chunks: {library_ms:.4f} ms")
        del ext, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve(graph, ds, gt, rows: str, dev, what: str = "native") -> tuple[int, float, float]:
    """Search all queries on ``rows`` rows; check recall and beam_step's
    launches in that run (one a layer-0 step, and the gated no-ops after
    the last), and return (launches, recall@10, QPS)."""
    t0 = time.perf_counter()
    index = HNSWIndex(graph, rows=rows, device=dev)
    torch.cuda.synchronize()
    log(f"[hnsw] upload {rows} rows: {time.perf_counter() - t0:.2f} s")
    index.search(ds.queries, SEARCH, batch_size=B)  # warm-up pass
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bs.beam_step.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[hnsw] {what} graph, {rows}: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s mean_hops={index.last_hops / NQ:.2f} "
        f"mean_dist_comps={index.last_dists / NQ:.1f} "
        f"beam_steps={index.last_steps} beam_step_launches={launches} "
        f"gather_score_launches={gather_score.launches}")
    if recall < MIN_RECALL:
        raise AssertionError(f"{rows}: recall@10 {recall:.4f} < {MIN_RECALL}")
    if not launches >= index.last_steps > 0:
        raise AssertionError(
            f"{rows}: {launches} beam_step launches for {index.last_steps} beam steps")
    return launches, recall, NQ / wall


def _compare(a_ids, a_d, b_ids, b_d, what: str, atol: float = ATOL) -> None:
    overlap = recall_at_k(b_ids, a_ids, 10)
    same = a_ids[:, :, None] == b_ids[:, None, :]  # (Q, k, k) id matches
    qi, ai, bi = np.nonzero(same)
    da, db = a_d[qi, ai], b_d[qi, bi]
    err = float(np.abs(da - db).max())
    log(f"[e2e] {what}: {len(a_ids)} queries cpu vs cuda: id overlap="
        f"{overlap:.4f} matched={len(qi)} max_abs_dist_err={err:.3e}")
    if overlap < MIN_OVERLAP:
        raise AssertionError(f"{what}: cpu/cuda id overlap {overlap:.4f} < "
                             f"{MIN_OVERLAP}")
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=atol)


def hnsw_end_to_end(graph, ds, dev) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = HNSWIndex(graph, rows="f32", device="cpu")
    a_ids, a_d = cpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    gpu = HNSWIndex(graph, rows="f32", device=dev)
    b_ids, b_d = gpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, "hnsw")


# --- phase 19: K1's fused beam step ------------------------------------------

STEP_QUERIES = 512  # queries of the whole searches compared step by step
MID_STEP = 8  # the step timed at B=4096, mid-search (~23 steps a batch)
DESCENT = SearchParams(k=10, ef=96, frontier=8, entry_mode="descent")
# the descent entry's floor: the greedy walk seeds one entry instead of the
# dense sweep's two, so its recall may sit a little under the dense entry's;
# below this it is broken, not mistuned
DESCENT_MIN_RECALL = 0.80


def _step_state(g, queries: np.ndarray, sp: SearchParams, dev) -> tuple:
    """(q_ext, bias, state): the dense entry's seeded layer-0 state."""
    q_ext, bias = _extend_query(torch.from_numpy(queries).to(dev), METRIC_L2)
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, True)
    return q_ext, bias, list(th._l0_state(seed_ids, seed_d, sp))


def _run_step(fn, g, q_ext, bias, state, t: int, sp: SearchParams) -> None:
    beam, hops, counts, uns = state
    fn(g.vectors_ext, g.neighbors0, q_ext, bias, beam, hops, counts, uns, t,
       frontier=sp.frontier, k=sp.k, term=sp.term, l2=True, row_scl=g.row_scl,
       row_nrm=g.row_nrm)


def _flat(state) -> list[torch.Tensor]:
    return list(state[0]) + list(state[1:])


def _clone_state(state) -> list:
    return [Beam(*(c.clone() for c in state[0]))] + [x.clone() for x in state[1:]]


def step_vs_twin(g, q_ext, bias, fused: list, sp: SearchParams, what: str
                 ) -> tuple[int, int]:
    """beam_step against beam_step_ref from the same seeded state ``fused``
    on ``g``'s rows and lists, bit for bit (dists as int32 words) after
    every step of a whole search. Returns (steps, entries compared)."""
    plain = _clone_state(fused)
    for t in range(sp.max_steps):
        _run_step(bs.beam_step, g, q_ext, bias, fused, t, sp)
        _run_step(bs.beam_step_ref, g, q_ext, bias, plain, t, sp)
        torch.cuda.synchronize()
        a, b = _flat(fused), _flat(plain)
        a[0], b[0] = a[0].view(torch.int32), b[0].view(torch.int32)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"beam_step {what}: differs from beam_step_ref "
                                 f"at step {t}")
        if int(fused[3][t + 1]) == 0:
            return t + 1, fused[0].ids.numel()
    return sp.max_steps, fused[0].ids.numel()


def _timed_step(fn, state, snapshot, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()``, the state restored from
    ``snapshot`` before each run (outside the timed window)."""
    times = []
    for i in range(warmup + reps):
        for x, y in zip(_flat(state), _flat(snapshot)):
            x.copy_(y)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def step_timing(g, q_ext, bias, state: list, sp: SearchParams, what: str) -> dict:
    """One mid-search step (step MID_STEP) of the seeded batch ``state``: the
    fused kernel and its twin by CUDA events, the lanes that hold an id and
    the ones kept after the duplicate drop, and the step's bound: the kept
    rows' bytes, the active lists, the beam read and written, the query rows
    and the counters, over the card's memory rate."""
    nq = q_ext.shape[0]
    for t in range(MID_STEP):
        _run_step(bs.beam_step, g, q_ext, bias, state, t, sp)
    t = MID_STEP
    if int(state[3][t]) == 0:
        raise AssertionError(f"beam_step {what}: the batch settled before step {t}")
    snapshot = _clone_state(state)
    _, active, lanes = bs.frontier_lists(state[0], g.neighbors0, sp.frontier)
    kept = bs.kept_lanes(state[0].ids, lanes)
    n_lanes, n_valid = lanes.numel(), int((lanes >= 0).sum())
    n_kept, n_active = int(kept.sum()), int(active.sum())
    W = g.neighbors0.shape[1]
    ms = _timed_step(lambda: _run_step(bs.beam_step, g, q_ext, bias, state, t, sp),
                     state, snapshot)
    plain_ms = _timed_step(
        lambda: _run_step(bs.beam_step_ref, g, q_ext, bias, state, t, sp),
        state, snapshot, reps=5, warmup=1)
    row_bytes = (g.vectors_ext.element_size() * D
                 + (8 if g.row_scl is not None else 0))
    nbytes = (n_kept * row_bytes + n_active * W * 4 + 2 * nq * sp.ef * 9
              + nq * (D + 1) * 4 + 2 * nq * 8)
    bms, by = bound_ms(nbytes, 4.0 * n_kept * D, PEAK_F32)
    log(f"[K1] beam_step {what}, step {t} of a batch of {nq} (ef={sp.ef}, frontier="
        f"{sp.frontier}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); lanes {n_lanes}, with an id {n_valid} "
        f"({100 * n_valid / n_lanes:.1f}%), kept after the duplicate drop {n_kept} "
        f"({100 * n_kept / max(n_valid, 1):.1f}% of those), active frontier slots "
        f"{n_active}")
    return dict(rows=what, batch=nq, ef=sp.ef, frontier=sp.frontier, step=t, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, lanes=n_lanes,
                valid_lanes=n_valid, kept_lanes=n_kept, active_slots=n_active)


def serve_descent(graph, ds, gt, dev) -> dict:
    """All queries through the descent entry on f32 rows: the greedy walk
    and the entry point's distance launch gather_score, the layer-0 steps
    beam_step. Checks both launch counts and the recall."""
    index = HNSWIndex(graph, rows="f32", device=dev)
    index.search(ds.queries, DESCENT, batch_size=B)  # warm-up pass
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, DESCENT, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, step = gather_score.launches, bs.beam_step.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[hnsw] descent entry, f32: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"mean_hops={index.last_hops / NQ:.2f} beam_steps={index.last_steps} "
        f"gather_score_launches={k1} beam_step_launches={step}")
    if recall < DESCENT_MIN_RECALL:
        raise AssertionError(f"descent: recall@10 {recall:.4f} < {DESCENT_MIN_RECALL}")
    if k1 == 0 or not step >= index.last_steps > 0:
        raise AssertionError(f"descent: {k1} gather_score and {step} beam_step "
                             f"launches for {index.last_steps} steps")
    return {"gather_score_launches": k1, "beam_step_launches": step,
            "recall@10": recall, "qps": NQ / wall}


def beam_step_phase(graph, ds, gt, dev) -> tuple[list[dict], dict]:
    """Phase 19; returns beam_step's cases (one a row type) and the descent
    entry's run."""
    sp = SEARCH.resolved()
    cases = []
    for rows in ("f32", "bf16", "int8"):
        g = th.device_graph(graph, rows=rows, device=dev)
        steps, entries = step_vs_twin(
            g, *_step_state(g, ds.queries[:STEP_QUERIES], sp, dev), sp, rows)
        log(f"[K1] beam_step {rows}: equal to beam_step_ref bit for bit after each "
            f"of the {steps} steps of {STEP_QUERIES} queries ({entries} beam entries)")
        case = step_timing(g, *_step_state(g, ds.queries[:B], sp, dev), sp, rows)
        case.update(max_abs_err=0.0, search_steps_compared=steps)
        cases.append(case)
        del g
        torch.cuda.empty_cache()
    index = HNSWIndex(graph, rows="f32", device=dev)
    profile_run(lambda: index.search(ds.queries[:B], SEARCH, batch_size=B),
                "hnsw f32")
    del index
    descent = serve_descent(graph, ds, gt, dev)
    return cases, descent


def serve_flat(index: FastFlatIndex, ds, gt, plan) -> tuple[dict, dict]:
    """All queries through each scan route; returns each route's kernel
    launches, checked non-zero, and its (recall@10, QPS), both logged."""
    launches, served = {}, {}
    pre = index.preload(ds.queries, batch_size=B)
    for route, knobs, kernel, cls, kb in plan:
        # warm-up: one pass of every query (one batch left the first
        # route's timed pass at a sixth of its speed after the native build)
        index.search(ds.queries, 10, batch_size=B, preloaded=pre, **knobs)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre,
                              **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, (fn, _, _) in K2_FORMS.items()}
        recall = recall_at_k(ids, gt, 10)
        log(f"[flat] {route}: {kernel} cls={cls} kb={kb} "
            f"recall@10={recall:.4f} qps={NQ / wall:.1f} wall={wall:.3f} s "
            f"launches={counts}")
        floor = FLAT_MIN_RECALL if route in ("auto", "keep2_point") \
            else FLAT_ROUTE_MIN_RECALL
        if recall < floor:
            raise AssertionError(f"fastflat {route}: recall@10 {recall:.4f} "
                                 f"< {floor}")
        if counts[kernel] == 0:
            raise AssertionError(f"fastflat {route}: {kernel} never launched")
        launches[kernel] = counts[kernel]
        served[route] = (recall, NQ / wall)
    return launches, served


def flat_end_to_end(ds, gpu: FastFlatIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = FastFlatIndex(ds.base, device="cpu")
    for route, knobs in FLAT_ROUTES[:2]:
        a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        _compare(a_ids, a_d, b_ids, b_d, f"fastflat {route}", FLAT_ATOL)


def split_route_plan(index: SplitFlatIndex) -> list[tuple]:
    """(route, knobs, function, keep2, cls, kb) of each SplitFlatIndex
    route, from the index's own knob resolution; fails unless the routes
    launch every K3 form (function x keep2), each on one route."""
    plan = []
    for route, knobs in SPLIT_ROUTES:
        kb, cls, keep2, fused = index._resolve_knobs(
            knobs.get("kb", 0), 0, knobs.get("keep2"), None, False)
        fn = "classmax_topk_scan_split" if fused else "classmax_scan_split"
        plan.append((route, knobs, fn, keep2, cls, min(kb, cls)))
    forms = sorted((p[2], p[3]) for p in plan)
    if forms != sorted((f, k2) for f in K3_FUNCS for k2 in (False, True)):
        raise AssertionError(f"the routes launch {forms}, not each K3 form once")
    return plan


def _k3_bound(keep2: bool, cls: int, kb: int | None, elt: int) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D (the zero
    columns and pad rows add none), their aux, B queries, the outputs."""
    planes = 4 if keep2 else 2
    nbytes = (N * (D * elt + 8) + B * D * 2
              + B * (cls if kb is None else kb) * 4 * planes)
    return bound_ms(nbytes, 2.0 * B * N * D, PEAK_BF16)


def _k3_rescored(comp, aux, q, planes, what: str) -> None:
    """Each selected row, scored again in f32 from the tables, has the
    score reported beside it (runner-ups that never entered excepted)."""
    qf = q.float()
    for s, r in zip(planes[::2], planes[1::2]):
        rl = r.long()
        dots = torch.einsum("bd,bkd->bk", qf, comp[rl].float())
        err = float((aux[1][rl] * dots + aux[0][rl] - s)[s > -3e38].abs().max())
        if err > K3_ATOL:
            raise AssertionError(f"{what}: a selected row scores {err} away "
                                 "from its reported score")


def _k3_form(fn_name, keep2, comp, aux, q, metric, cls, kb, cases) -> tuple:
    """One form at one shape against its twin; times it under L2 and
    records the case. Returns the kernel's outputs."""
    fn, ref, _ = K3_FUNCS[fn_name]
    kw = {"cls": cls, "keep2": keep2, **({} if kb is None else {"kb": kb})}
    got = fn(comp, aux, q, **kw)
    torch.cuda.synchronize()
    err = _k2_err(got, ref(comp, aux, q, **kw), cls)
    what = (f"{fn_name} {'int8' if comp.dtype == torch.int8 else 'bf16'} "
            f"keep2={keep2} {metric} cls={cls} kb={kb}")
    if err > K3_ATOL:
        raise AssertionError(f"{what}: scores differ by {err} > {K3_ATOL}")
    case = {"metric": metric, "cls": cls, "kb": kb, "max_abs_err": err}
    msg = f"[K3] {what}: max_abs_err={err:.3e}"
    if metric == "l2":
        case["ms"] = cuda_ms(lambda: fn(comp, aux, q, **kw), reps=10)
        case["plain_ms"] = cuda_ms(lambda: ref(comp, aux, q, **kw), reps=3, warmup=1)
        case["bound_ms"], case["bound_by"] = _k3_bound(keep2, cls, kb,
                                                       comp.element_size())
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} "
                f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
    cases[(fn_name, keep2)].append(case)
    log(msg)
    return got


def k3_vs_twin(base: np.ndarray, queries: np.ndarray, dev, plan,
               comp_dtype: str) -> tuple[dict, float]:
    """Every K3 form against its twin on the set's split tables of one
    comp dtype: the unfused forms at each cls of the plan and of
    K3_EXTRA_SHAPE, each fused form at its route's (cls, kb) and at
    K3_EXTRA_SHAPE. Returns each form's cases and the yardstick's ms."""
    n_pad = -(-N // SPLIT_QUANTUM) * SPLIT_QUANTUM
    shapes = {(fn, keep2): {(cls, kb if "topk" in fn else None),
                            (K3_EXTRA_SHAPE[0], K3_EXTRA_SHAPE[1] if "topk" in fn
                             else None)}
              for _, _, fn, keep2, cls, kb in plan}
    cases: dict = {form: [] for form in shapes}
    library_ms = None
    for metric, mid in (("l2", 0), ("ip", 1)):
        comp, aux = pack_split_tables(base, mid, n_pad, comp_dtype=comp_dtype,
                                      device=dev)
        q = pack_split_query(torch.from_numpy(queries[:B]).to(dev), comp.shape[1])
        for cls in sorted({c for form in shapes.values() for c, _ in form}):
            lane = torch.arange(cls, device=dev, dtype=torch.int32)
            t1, tr1, t2, _ = cm.classmax_scan_split_ref(comp, aux, q, cls=cls,
                                                        keep2=True)
            clear = (t1 - t2) > K3_ATOL  # the twin's winner is unambiguous
            unfused = {}
            for keep2 in (False, True):
                got = _k3_form("classmax_scan_split", keep2, comp, aux, q,
                               metric, cls, None, cases)
                if not torch.equal(got[1] % cls, lane.expand_as(got[1])):
                    raise AssertionError("classmax_scan_split: a row outside "
                                         "its class")
                if not torch.equal(got[1][clear], tr1[clear]):
                    raise AssertionError(f"classmax_scan_split keep2={keep2} "
                                         f"{metric} cls={cls}: rows differ "
                                         "where the winner is clear")
                unfused[keep2] = got
            for keep2 in (False, True):
                kbs = sorted(kb for c, kb in shapes[("classmax_topk_scan_split",
                                                     keep2)] if c == cls)
                for kb in kbs:
                    got = _k3_form("classmax_topk_scan_split", keep2, comp, aux,
                                   q, metric, cls, kb, cases)
                    _k3_rescored(comp, aux, q, got, "classmax_topk_scan_split")
                    vals, sel = cm.select_lanes(unfused[keep2][0], kb)
                    expect = (vals,) + tuple(torch.gather(p, 1, sel)
                                             for p in unfused[keep2][1:])
                    if not all(torch.equal(g, e) for g, e in zip(got, expect)):
                        raise AssertionError(
                            f"classmax_topk_scan_split {comp_dtype} keep2={keep2}"
                            f" {metric} cls={cls} kb={kb}: the fused select is "
                            "not the unfused form plus select")
            del t1, tr1, t2, clear, unfused
        if metric == "l2":
            # the yardstick: the bare bf16 product in 65,536-row chunks, on
            # the table widened to bf16 beforehand when it is int8
            wide = comp.to(torch.bfloat16)

            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, wide[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K3] torch.matmul bf16 ({B}, {D}) x ({n_pad}, {D})^T in "
                f"65,536-row chunks ({comp_dtype} table"
                f"{', widened before timing' if comp_dtype == 'int8' else ''}): "
                f"{library_ms:.4f} ms")
            del wide
        del comp, aux, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve_split(index: SplitFlatIndex, ds, gt, plan) -> tuple[dict, dict]:
    """All queries through each route; returns each route's launches of
    its K3 form, checked non-zero, and its (recall@10, QPS), both logged."""
    launches, served = {}, {}
    pre = index.preload(ds.queries, batch_size=B)
    for route, knobs, fn, keep2, cls, kb in plan:
        index.search(ds.queries[:B], 10, batch_size=B, **knobs)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre,
                              **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {f"{name}[{dt},keep{2 if k2 else 1}]": n
                  for name, (f, _, _) in K3_FUNCS.items()
                  for (dt, k2), n in f.form_launches.items()}
        n = K3_FUNCS[fn][0].form_launches.get((index.comp_dtype, keep2), 0)
        recall = recall_at_k(ids, gt, 10)
        log(f"[split] {index.comp_dtype} {route}: {fn} keep2={keep2} cls={cls} "
            f"kb={kb} recall@10={recall:.4f} qps={NQ / wall:.1f} "
            f"wall={wall:.3f} s launches={counts}")
        floor = (SPLIT_MIN_RECALL if (route, index.comp_dtype) == ("auto", "bf16")
                 else FLAT_ROUTE_MIN_RECALL)
        if recall < floor:
            raise AssertionError(f"split {index.comp_dtype} {route}: recall@10 "
                                 f"{recall:.4f} < {floor}")
        if n == 0:
            raise AssertionError(f"split {index.comp_dtype} {route}: {fn} "
                                 f"keep2={keep2} never launched")
        launches[route] = n
        served[route] = (recall, NQ / wall)
    return launches, served


def profile_batch(index, queries: np.ndarray, what: str) -> None:
    """Device time by kernel over one batch of B queries at the auto knobs
    (torch.profiler, after a warm-up batch), and the card's busy share of
    the batch's host span."""
    pre = index.preload(queries[:B], batch_size=B)
    profile_run(lambda: index.search_device(pre, 10, batch_size=B), what)


def profile_run(run, what: str) -> None:
    """``profile_batch`` of any one-batch call ``run``."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    # device events only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {what}, one batch of {B}: span {span_ms:.3f} ms (profiled), "
        f"device busy {busy:.3f} ms ({100 * busy / span_ms:.1f}%)")
    for ms, count, key in rows[:8]:
        if ms > 0:
            log(f"[profile]   {ms:8.4f} ms {100 * ms / busy:5.1f}% x{count} {key[:90]}")


def split_end_to_end(ds, gpu: SplitFlatIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = SplitFlatIndex(ds.base, comp_dtype=gpu.comp_dtype, device="cpu")
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, f"split {gpu.comp_dtype} auto", FLAT_ATOL)


def split_phases(ds, gt, dev) -> tuple[list[dict], dict]:
    """Phases 9-11 for both comp dtypes; the K3 entries of the kernel
    table, each at the shape of the route whose launches it reports, and
    each (comp dtype, route)'s (recall@10, QPS)."""
    kernels, served = [], {}
    for comp_dtype in SPLIT_DTYPES:
        t0 = time.perf_counter()
        index = SplitFlatIndex(ds.base, comp_dtype=comp_dtype, device=dev)
        torch.cuda.synchronize()
        log(f"[split] SplitFlatIndex {comp_dtype} build (shuffle, host pack "
            f"{tuple(index.comp.shape)} + aux {tuple(index.aux.shape)}, copy to "
            f"the card): {time.perf_counter() - t0:.2f} s")
        plan = split_route_plan(index)
        cases, library_ms = k3_vs_twin(ds.base, ds.queries, dev, plan, comp_dtype)
        launches, by_route = serve_split(index, ds, gt, plan)
        served.update({(comp_dtype, r): v for r, v in by_route.items()})
        profile_batch(index, ds.queries, f"split {comp_dtype} auto")
        split_end_to_end(ds, index)
        del index
        torch.cuda.empty_cache()
        for route, _, fn, keep2, cls, kb in plan:
            kb = kb if "topk" in fn else None
            at = [c for c in cases[(fn, keep2)] if (c["cls"], c["kb"]) == (cls, kb)]
            main_k3 = next(c for c in at if c["metric"] == "l2")
            kernels.append({
                "name": f"{fn}[{comp_dtype},keep{2 if keep2 else 1}]",
                "route": "cuda",
                "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
                "replaces": K3_FUNCS[fn][2],
                "launches": launches[route],
                "max_abs_err": max(c["max_abs_err"] for c in at),
                "ms": main_k3["ms"],
                "plain_ms": main_k3["plain_ms"],
                "bound_ms": main_k3["bound_ms"],
                "bound_by": main_k3["bound_by"],
                "library_ms": library_ms,
                "split_route": route,
                "comp_dtype": comp_dtype,
                "keep2": keep2,
                "cls": cls,
                "kb": kb,
                "cases": cases[(fn, keep2)],
            })
    return kernels, served


def serve_routed(index: RoutedSplitIndex, ds, gt) -> dict[str, dict]:
    """All queries through each routed route; returns each route's knobs,
    K4 launches by form and spilled queries, with recall, QPS and coverage
    logged; fails on recall, on a route that launched no K4, and on a
    starved route that spilled nothing."""
    served = {}
    pre = index.preload(ds.queries, batch_size=B)
    probes = rs._auto_probes(index.C)
    for route, knobs in ROUTED_ROUTES:
        T, P = rs._auto_knobs(index.C, probes, knobs.get("tile", 0), knobs.get("shared", 0))
        index.search(ds.queries[:B], 10, batch_size=B, **knobs)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre, **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forms = {f"{dt},T{t}": n for (dt, t), n in k4.routed_classmax_scan.form_launches.items()}
        recall = recall_at_k(ids, gt, 10)
        log(f"[routed] {route}: probes={probes} T={T} shared={P} kk={min(80, index.cls)} "
            f"recall@10={recall:.4f} qps={NQ / wall:.1f} wall={wall:.3f} s "
            f"coverage={index.last_coverage:.4f} fallback={index.last_fallback} "
            f"K4 launches={forms}")
        if recall < ROUTED_MIN_RECALL:
            raise AssertionError(f"routed {route}: recall@10 {recall:.4f} < "
                                 f"{ROUTED_MIN_RECALL}")
        if not forms.get(f"int8,T{T}"):
            raise AssertionError(f"routed {route}: K4 at T={T} never launched")
        if route == "starved" and not (index.last_fallback and forms.get("int8,T16")):
            raise AssertionError("routed starved: the fallback spill never ran")
        served[route] = {"T": T, "P": P, "probes": probes, "forms": forms,
                         "spill": index.last_spill.copy(), "recall": recall,
                         "qps": NQ / wall, "coverage": index.last_coverage,
                         "fallback": index.last_fallback}
    return served


def routed_end_to_end(ds, gpu: RoutedSplitIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = RoutedSplitIndex(
        *(t.cpu() for t in (gpu.centroids, gpu.comp, gpu.aux_r, gpu.gid)),
        gpu.n, gpu.dim, gpu.metric, cls=gpu.cls, cap=gpu.cap,
        base_dev=gpu.base_dev.cpu(), sqnorms=gpu.sqnorms.cpu())
    t0 = time.perf_counter()
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    log(f"[e2e] routed auto on the CPU (twins): {time.perf_counter() - t0:.2f} s")
    b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, "routed auto", FLAT_ATOL)


def _k4_inputs(index: RoutedSplitIndex, ds, served, dev) -> list[tuple]:
    """(route, T, affinity-sorted queries, cols) of each route's K4 launch:
    the auto and tile=32 routes' first batch, the starved route's spill
    batch (its spilled queries, zero-padded to the spill's bucket)."""
    q_all = torch.from_numpy(ds.queries).to(dev)
    out = []
    for route in ("auto", "tile32", "starved"):
        sv = served[route]
        q, T, P = q_all[:B], sv["T"], sv["P"]
        if route == "starved":
            need = torch.from_numpy(sv["spill"]).to(dev)
            T, P, bucket = rs._spill_plan(len(need), sv["probes"], index.C)
            q = torch.zeros((bucket, D), dtype=torch.float32, device=dev)
            q[:len(need)] = q_all[need]
        perm, _, cols, _, _ = rs.route_batch(index.centroids, q, metric=METRIC_L2,
                                             p=sv["probes"], P=P, T=T, C=index.C)
        out.append((route, T, q[perm], cols))
    return out


def _k4_bound(cols: torch.Tensor, C: int, cap: int, T: int, elt: int, cls: int
              ) -> tuple[float, str, float]:
    """The work the call needs: the bf16 products of each group's T queries
    with the real (not pad) clusters its columns name, at width D; the
    bytes of every cluster the batch is granted read once (rows and their
    nrm and scl), the queries and the outputs. Also the bytes the groups
    read between them (each group its own P blocks)."""
    G, P = cols.shape
    real = int((cols < C).sum())
    uniq = int(torch.unique(cols[cols < C]).numel())
    row_bytes = D * elt + 8
    nbytes = uniq * cap * row_bytes + G * T * D * 2 + G * T * cls * 8 + cols.numel() * 4
    flops = 2.0 * T * real * cap * D
    bms, by = bound_ms(nbytes, flops, PEAK_BF16)
    return bms, by, G * P * cap * row_bytes


def _k4_library_ms(comp, aux_r, q, cols, T: int, cap: int) -> float:
    """The yardstick: a bf16 torch.bmm of each group's queries against its
    gathered (and, for int8, widened) blocks, in chunks of about 1 GB of
    blocks; the gathers are not timed."""
    G, P = cols.shape
    dpc = comp.shape[1]
    comp3 = comp[: aux_r.shape[0] * cap].view(aux_r.shape[0], cap, dpc)
    per = max(1, (1 << 30) // (P * cap * dpc * 2))
    total = 0.0
    for g0 in range(0, G, per):
        c = cols[g0:g0 + per].long()
        blk = comp3[c].view(c.shape[0], P * cap, dpc).to(torch.bfloat16)
        qg = q[g0 * T:(g0 + c.shape[0]) * T].view(c.shape[0], T, dpc)
        total += cuda_ms(lambda: torch.bmm(qg, blk.transpose(1, 2)), reps=3, warmup=1)
        del blk
    return total


def _k4_case(comp, aux_r, q_s, cols, T: int, cap: int, cls: int, what: str,
             timed: bool) -> dict:
    """K4 against its twin on one table and one route's inputs: the score
    error, and rows equal wherever the twin's winner is clear: a lane whose
    row differs must hold a row that scores within K4_ATOL of the twin's
    best. Times kernel, twin and yardstick when ``timed``."""
    q = pack_split_query(q_s, comp.shape[1])
    kw = {"T": T, "cap": cap, "cls": cls}
    best, rows = k4.routed_classmax_scan(comp, aux_r, q, cols, **kw)
    torch.cuda.synchronize()
    want_b, want_r = k4.routed_classmax_scan_ref(comp, aux_r, q, cols, **kw)
    err = float((best - want_b).abs().max())
    if err > K4_ATOL:
        raise AssertionError(f"K4 {what}: scores differ by {err} > {K4_ATOL}")
    differ = rows != want_r
    if bool(differ.any()):
        b_i, l_i = torch.nonzero(differ, as_tuple=True)
        r = rows[b_i, l_i].long()
        g = b_i // T
        trow = cols[g, r // cap].long() * cap + r % cap
        c = cols[g, r // cap].long()
        m = (r % cap) // cls
        members = cap // cls
        dots = (q[b_i].float() * comp[trow].float()).sum(1)
        rescored = aux_r[c, members + m, l_i] * dots + aux_r[c, m, l_i]
        if bool(((want_b[b_i, l_i] - rescored) > K4_ATOL).any()):
            raise AssertionError(f"K4 {what}: rows differ where the twin's "
                                 "winner is clear")
    case = {"what": what, "T": T, "B": int(q.shape[0]), "P": int(cols.shape[1]),
            "max_abs_err": err, "rows_differ": int(differ.sum())}
    msg = f"[K4] {what}: max_abs_err={err:.3e} rows_differ={case['rows_differ']}"
    if timed:
        case["ms"] = cuda_ms(lambda: k4.routed_classmax_scan(comp, aux_r, q, cols, **kw),
                             reps=10)
        case["plain_ms"] = cuda_ms(
            lambda: k4.routed_classmax_scan_ref(comp, aux_r, q, cols, **kw), reps=3,
            warmup=1)
        case["library_ms"] = _k4_library_ms(comp, aux_r, q, cols, T, cap)
        case["bound_ms"], case["bound_by"], case["group_bytes"] = _k4_bound(
            cols, aux_r.shape[0] - 1, cap, T, comp.element_size(), cls)
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                f"bmm {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
                f"({case['bound_by']}), per-group bytes {case['group_bytes'] / 1e9:.3f} GB")
    log(msg)
    return case


def k4_vs_twin(index: RoutedSplitIndex, ds, served, dev) -> dict[tuple, list]:
    """Phase 13: K4 against its twin on every route's inputs, on the int8
    table of the index and on bf16 and IP tables packed in its order."""
    inputs = _k4_inputs(index, ds, served, dev)
    cases: dict[tuple, list] = {}
    for comp_dtype, metric in (("int8", METRIC_L2), ("bf16", METRIC_L2),
                               ("int8", METRIC_IP), ("bf16", METRIC_IP)):
        if (comp_dtype, metric) == ("int8", METRIC_L2):
            comp, aux_r = index.comp, index.aux_r
        else:
            comp, aux_r = rs.pack_clustered(index.base_dev, index.gid, metric,
                                            cap=index.cap, cls=index.cls,
                                            comp_dtype=comp_dtype)
        mname = "l2" if metric == METRIC_L2 else "ip"
        for route, T, q_s, cols in inputs:
            case = _k4_case(comp, aux_r, q_s, cols, T, index.cap, index.cls,
                            f"{comp_dtype} {mname} {route} T={T}",
                            timed=metric == METRIC_L2)
            case.update(comp_dtype=comp_dtype, metric=mname, route=route)
            cases.setdefault((comp_dtype, T), []).append(case)
        del comp, aux_r
        torch.cuda.empty_cache()
    return cases


def _routed_build(base_t) -> tuple[RoutedSplitIndex, float]:
    """The routed build at ROUTED_BUILD, its log lines, and the share of
    rows placed in their first choice (r0) that it reports."""
    lines = []

    def say(m):
        lines.append(m)
        log(f"[routed] {m}")

    t0 = time.perf_counter()
    index = build_routed_split(RN, D, base_dev=base_t, log=say, **ROUTED_BUILD)
    torch.cuda.synchronize()
    log(f"[routed] build on the card: {time.perf_counter() - t0:.2f} s, C={index.C} "
        f"cap={index.cap} comp {tuple(index.comp.shape)} {index.comp.dtype} aux_r "
        f"{tuple(index.aux_r.shape)}")
    r0 = next(float(m.split("r0=")[1].split()[0]) for m in lines if "r0=" in m)
    return index, r0


def routed_rebuild_is_identical(index: RoutedSplitIndex, r0: float, served, base_t,
                                ds) -> None:
    """ROADMAP C9: a second build of the same seed on the card places every
    row as the first did (the k-means sums no longer use float atomics):
    equal r0, equal centroids and layout, and the starved route spills the
    same queries."""
    again, r0_again = _routed_build(base_t)
    again.search(ds.queries, 10, batch_size=B, **dict(ROUTED_ROUTES)["starved"])
    spill, spill_again = served["starved"]["spill"], again.last_spill
    log(f"[routed] C9, two builds of seed {ROUTED_BUILD['seed']}: r0 {r0:.4f} and "
        f"{r0_again:.4f}; starved spill {len(spill)} and {len(spill_again)} queries; "
        f"centroids equal {torch.equal(index.centroids, again.centroids)}, layout equal "
        f"{torch.equal(index.gid, again.gid)}")
    if (r0 != r0_again or not np.array_equal(spill, spill_again)
            or not torch.equal(index.centroids, again.centroids)
            or not torch.equal(index.gid, again.gid)):
        raise AssertionError("C9: two routed builds of one seed differ on the card")
    del again
    torch.cuda.empty_cache()


def routed_phases(dev) -> list[dict]:
    """Phases 12-13 on the 4.19M set; K4's entries of the kernel table,
    one a form (int8 table, T), each at the route that launched it."""
    t0 = time.perf_counter()
    ds = synthetic_dataset(n=RN, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    log(f"[data] {RN} x {D}, {NQ} queries: {time.perf_counter() - t0:.2f} s")
    base_t = torch.from_numpy(ds.base).to(dev)
    t0 = time.perf_counter()
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    gt = gt.cpu().numpy()
    log(f"[routed] exact fp32 ground truth on the card: {time.perf_counter() - t0:.2f} s")
    index, r0 = _routed_build(base_t)
    served = serve_routed(index, ds, gt)
    profile_run(lambda: index.search(ds.queries[:B], 10, batch_size=B), "routed auto")
    routed_end_to_end(ds, index)
    routed_rebuild_is_identical(index, r0, served, base_t, ds)
    cases = k4_vs_twin(index, ds, served, dev)
    kernels = []
    for route in ("auto", "tile32", "starved"):
        T = 16 if route == "starved" else served[route]["T"]
        at = cases[("int8", T)]
        main = next(c for c in at if c["metric"] == "l2")
        kernels.append({
            "name": f"routed_classmax_scan[int8,T{T}]",
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
            "replaces": "shine_tpu/ops/pallas_scan_routed.py:106",
            "launches": served[route]["forms"][f"int8,T{T}"],
            "max_abs_err": max(c["max_abs_err"] for c in at),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "routed_route": route,
            "T": T,
            "B": main["B"],
            "P": main["P"],
            "recall@10": served[route]["recall"],
            "qps": served[route]["qps"],
            "cases": at + cases[("bf16", T)],
        })
    del index, base_t
    torch.cuda.empty_cache()
    return kernels


# --- phases 14-18: K5 and K6, FastFlat's block-max route, the scan-speed build

K56_FORMS = {
    "blockmax_scan": (bm.blockmax_scan, bm.blockmax_scan_ref,
                      "shine_tpu/ops/pallas_scan.py:63",
                      "shine_tpu_torch/csrc/classmax2_scan.cu"),
    "blockmax_scan2": (bm.blockmax_scan2, bm.blockmax_scan2_ref,
                       "shine_tpu/ops/pallas_scan2.py:94",
                       "shine_tpu_torch/csrc/classmax2_scan.cu"),
}
# K5 and K6 score K2's table with K2's products: K2's bound on the sum order
K56_ATOL = K2_ATOL
# the builds on the card: the scan-speed default (pool 0: k = 2M = 32), the
# JAX package's construction-quality parity setting (pool = efc = 200), and
# the block-max sweep; each graph is served as the native one is
BUILDS = (("pool0", {}), ("pool200", {"pool": BUILD.ef_construction}),
          ("blockmax", {"blockmax": True}))
BLOCKMAX_BUILD_GAP = 0.01  # block-max graph's recall against the pool-0 one's
# the CPU-against-card build: Gaussian rows, whose f32 sums differ by ulps
# between the twins and the kernels and reorder a few near ties (the CPU
# tests hold the same to the JAX package)
SMALL_SET = dict(n=8192, dim=16, num_queries=256, seed=21)
SMALL_BUILD = HNSWParams(M=8, ef_construction=50)
SMALL_MIN_OVERLAP, SMALL_RECALL_GAP = 0.95, 0.01


def _int_case(metric: int, n_pad: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The set's shape in integer entries (every score exact in f32): rows
    with ties inside a block and across blocks, the n_pad - N pad rows of
    FastFlat's table, B integer queries."""
    rng = np.random.default_rng(SEED + metric)
    v = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    v[40:48] = v[39]
    v[QUANTUM + 5] = v[5]
    q = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
    ext = pack_ext_table(v, metric, n_pad, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(q).to(dev), ext.shape[1])
    return ext, q_ext.to(torch.bfloat16)


def _k56_bound(name: str, n_pad: int) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D+2, B queries,
    and every output (K5: four (B, n_pad/128) planes; K6: two (B, n_pad/32))."""
    width = D + 2
    planes, per_col = (4, bm.BLK) if name == "blockmax_scan" else (2, bm.BLK2)
    nbytes = N * width * 2 + B * width * 2 + B * (n_pad // per_col) * 4 * planes
    return bound_ms(nbytes, 2.0 * B * N * width, PEAK_BF16)


def _rows_near(ext, q, got_rows, want_rows, want_best, what: str) -> int:
    """Rows equal to the twin's, except where the kernel's row scores within
    K56_ATOL of the twin's best (near ties summed in another order).
    Returns how many differ."""
    differ = got_rows != want_rows
    if bool(differ.any()):
        b_i, c_i = torch.nonzero(differ, as_tuple=True)
        r = got_rows[b_i, c_i].long()
        rescored = (q[b_i].float() * ext[r].float()).sum(1)
        if bool(((want_best[b_i, c_i] - rescored).abs() > K56_ATOL).any()):
            raise AssertionError(f"{what}: rows differ where the twin's best is clear")
    return int(differ.sum())


def blockmax_vs_twin(base: np.ndarray, queries: np.ndarray, dev) -> tuple[dict, float]:
    """Phase 14: K5 and K6 against their twins on FastFlat's packed table
    (1,003,520 rows, 3,520 of them pad rows), B=4096, L2 and IP: bit for bit
    on integer entries, to K56_ATOL on the set's rows; timed under L2 with
    the bare bf16 product beside them. Returns each form's cases and the
    yardstick's ms."""
    n_pad = -(-N // QUANTUM) * QUANTUM
    cases: dict[str, list] = {name: [] for name in K56_FORMS}
    library_ms = None
    for metric, mid in (("l2", METRIC_L2), ("ip", METRIC_IP)):
        ext, q = _int_case(mid, n_pad, dev)
        for name, (fn, ref, _, _) in K56_FORMS.items():
            got = fn(ext, q)
            torch.cuda.synchronize()
            want = ref(ext, q)
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want)):
                raise AssertionError(f"{name} {metric}: the kernel and the twin differ "
                                     "on the integer table")
            log(f"[K5/K6] {name} {metric}: integer table {tuple(ext.shape)} "
                f"({n_pad - N} pad rows): bit for bit")
            del got, want
        ext = pack_ext_table(base, mid, n_pad, device=dev)
        q = pack_ext_query(torch.from_numpy(queries[:B]).to(dev), ext.shape[1]).to(
            torch.bfloat16)
        for name, (fn, ref, _, _) in K56_FORMS.items():
            got = fn(ext, q)
            torch.cuda.synchronize()
            want = ref(ext, q)
            err = max(float((g - w).abs().max()) for g, w in zip(got[::2], want[::2]))
            if err > K56_ATOL:
                raise AssertionError(f"{name} {metric}: scores differ by {err} > {K56_ATOL}")
            differ = _rows_near(ext, q, got[1], want[1], want[0], name)
            if name == "blockmax_scan":  # runner-ups that entered
                real = want[2] > -3e38
                differ += _rows_near(ext, q, torch.where(real, got[3], want[3]), want[3],
                                     want[2], name)
            case = {"metric": metric, "max_abs_err": err, "rows_differ": differ}
            msg = f"[K5/K6] {name} {metric}: max_abs_err={err:.3e} rows_differ={differ}"
            if metric == "l2":
                case["ms"] = cuda_ms(lambda: fn(ext, q), reps=10)
                case["plain_ms"] = cuda_ms(lambda: ref(ext, q), reps=3, warmup=1)
                case["bound_ms"], case["bound_by"] = _k56_bound(name, n_pad)
                msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
            cases[name].append(case)
            log(msg)
            del got, want
        if metric == "l2":
            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, ext[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K5/K6] torch.matmul bf16 ({B}, {ext.shape[1]}) x ({n_pad}, "
                f"{ext.shape[1]})^T in 65,536-row chunks: {library_ms:.4f} ms")
        del ext, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve_blockmax(flat: FastFlatIndex, ds, gt) -> dict:
    """Phase 15: all queries through FastFlat's block-max route (K5, the
    route the JAX package takes under interpret) at the auto kb; recall,
    QPS after a warm-up batch, K5's launches (no class-max launch); then
    256 queries on the CPU (twins) against the card."""
    flat.blockmax = True
    pre = flat.preload(ds.queries, batch_size=B)
    flat.search(ds.queries, 10, batch_size=B, preloaded=pre)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = flat.search(ds.queries, 10, batch_size=B, preloaded=pre)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bm.blockmax_scan.launches
    classmax = sum(fn.launches for fn, _, _ in K2_FORMS.values())
    recall = recall_at_k(ids, gt, 10)
    kb = flat._resolve_knobs(0, 0, None, None, False)[0]
    log(f"[flat] blockmax: kb={kb} blocks recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s blockmax_scan launches={launches} class-max launches={classmax}")
    if recall < FLAT_MIN_RECALL:
        raise AssertionError(f"fastflat blockmax: recall@10 {recall:.4f} < {FLAT_MIN_RECALL}")
    if launches == 0 or classmax:
        raise AssertionError(f"fastflat blockmax: {launches} K5 and {classmax} class-max "
                             "launches")
    q = ds.queries[:E2E_QUERIES]
    cpu = FastFlatIndex(ds.base, blockmax=True, device="cpu")
    t0 = time.perf_counter()
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    log(f"[e2e] fastflat blockmax on the CPU (twins): {time.perf_counter() - t0:.2f} s")
    b_ids, b_d = flat.search(q, 10, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, "fastflat blockmax", FLAT_ATOL)
    flat.blockmax = False
    return {"launches": launches, "recall@10": recall, "qps": NQ / wall, "kb": kb}


def _stage_line(timings: dict) -> str:
    parts = []
    for lv in timings["levels"]:
        stages = " ".join(f"{k}={v:.2f}" for k, v in lv.items() if k != "n")
        parts.append(f"n={lv['n']}: {stages}")
    return "; ".join(parts)


def build_phases(ds, gt, dev) -> dict:
    """Phases 16-17: fast_build_graph on the card at 1M, M=16, the rows
    resident: pool 0 and pool 200 through the class-max sweep, then the
    block-max sweep (K5); each build's stage times, the sweep's plan and its
    kernel launches, then its graph served as the native one is."""
    base_t = torch.from_numpy(ds.base).to(dev)
    out = {}
    for name, kw in BUILDS:
        torch.cuda.synchronize()
        reset_launches()
        t = {}
        t0 = time.perf_counter()
        graph = fast_build_graph(ds.base, BUILD, base_dev=base_t, timings=t, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, (fn, _, _) in K2_FORMS.items()}
        counts.update({n: fn.launches for n, (fn, _, _, _) in K56_FORMS.items()})
        counts = {k: v for k, v in counts.items() if v}
        plan = t["plan"]
        log(f"[build] {name}: {wall:.2f} s (stages {t['total']:.2f} s), "
            f"top_level={graph.top_level}, upper vertices={int((graph.levels > 0).sum())}")
        budget = "none" if plan["budget"] is None else f"{plan['budget'] / 1e9:.2f} GB"
        log(f"[build]   sweep plan: layout={plan['layout']} batch={plan['batch']} "
            f"kb={plan['kb']} keep2={plan['keep2']} cls={plan['cls']} planned "
            f"{plan['total'] / 1e9:.3f} GB, budget {budget}")
        log(f"[build]   stage seconds: {_stage_line(t)}; components="
            f"{t['components']:.2f}; upper levels={t['upper_levels']:.2f}")
        log(f"[build]   kernel launches in the build: {counts}")
        sweep = "blockmax_scan" if kw.get("blockmax") else "classmax2_scan"
        if counts.get(sweep, 0) < N // plan["batch"]:
            raise AssertionError(f"build {name}: {sweep} launched "
                                 f"{counts.get(sweep, 0)} times for the sweep")
        _, recall, qps = serve(graph, ds, gt, "f32", dev, what=f"fast_build {name}")
        out[name] = {"seconds": wall, "timings": {
            "levels": t["levels"], "components": t["components"],
            "upper_levels": t["upper_levels"]},
            "plan": {k: v for k, v in plan.items()}, "launches": counts,
            "recall@10": recall, "qps": qps}
        del graph
        torch.cuda.empty_cache()
    gap = abs(out["blockmax"]["recall@10"] - out["pool0"]["recall@10"])
    log(f"[build] block-max graph against the pool-0 graph: recall gap {gap:.4f} "
        f"(stated {BLOCKMAX_BUILD_GAP})")
    if gap > BLOCKMAX_BUILD_GAP:
        raise AssertionError(f"block-max build: recall {out['blockmax']['recall@10']:.4f}"
                             f" against {out['pool0']['recall@10']:.4f}")
    del base_t
    torch.cuda.empty_cache()
    return out


def small_build_cpu_vs_card(dev) -> None:
    """Phase 18: the same build at 8192 x 16 on the CPU (twins) and on the
    card: equal levels and entry point, overlapping layer-0 lists, and the
    same recall of 256 queries served from each."""
    small = synthetic_dataset(**SMALL_SET)
    base = torch.from_numpy(small.base)
    cpu = fast_build_graph(small.base, SMALL_BUILD, base_dev=base)
    gpu = fast_build_graph(small.base, SMALL_BUILD, base_dev=base.to(dev))
    if not np.array_equal(cpu.levels, gpu.levels) or cpu.entry_point != gpu.entry_point:
        raise AssertionError("small build: levels or entry point differ CPU/card")
    hits = sum(np.intersect1d(a[a >= 0], b[b >= 0]).size
               for a, b in zip(cpu.neighbors0, gpu.neighbors0))
    overlap = hits / max(int((cpu.neighbors0 >= 0).sum()), 1)
    recalls = []
    for g in (cpu, gpu):
        ids, _ = HNSWIndex(g, device=dev).search(
            small.queries, SearchParams(k=10, ef=64), batch_size=256)
        recalls.append(recall_at_k(ids, small.ground_truth, 10))
    log(f"[e2e] fast_build 8192 x 16, CPU against card: levels and entry equal, "
        f"layer-0 overlap {overlap:.4f} (stated {SMALL_MIN_OVERLAP}), recall@10 "
        f"{recalls[0]:.4f} and {recalls[1]:.4f}, identical lists "
        f"{np.array_equal(cpu.neighbors0, gpu.neighbors0)}")
    if overlap < SMALL_MIN_OVERLAP or abs(recalls[0] - recalls[1]) > SMALL_RECALL_GAP:
        raise AssertionError("small build: the CPU and card graphs differ too much")


# --- phases 20-21: the insert build on the card and the online index --------

# phase 20: device_build_graph at its defaults (batch_size=512, first_batch=32,
# level_cap=12) and BUILD, on the first DEVBUILD_N rows of the set
DEVBUILD_N = N
# the JAX package's own parity bound for this build against the native one
# (tests/test_build.py:test_device_build_parity_with_native)
DEVBUILD_GAP = 0.02
DET_N = 65_536  # two builds of these rows must be bit-identical
# the CPU-against-card build: integer entries, every distance exact, so the
# twins and the kernels build the same graph
INT_BUILD_SET = dict(n=4096, d=16, seed=13)
INT_BUILD = HNSWParams(M=8, ef_construction=40)
# phase 21: the online index, fed ONLINE_CHUNKS chunks of the set's rows
ONLINE_CAP, ONLINE_CHUNKS = 262_144, 4
ONLINE_MIN_RECALL = 0.90
ONLINE_STEP_CHECK = 2  # the build's beam_step is checked after this chunk
GRAPH_FIELDS = ("levels", "neighbors0", "upper_row", "upper_neighbors")


def _launches() -> dict[str, int]:
    return {"beam_step": bs.beam_step.launches, "gather_score": gather_score.launches}


def _same_graph(a, b, what: str) -> None:
    """Fail unless two GraphSoA hold the same lists, levels and entry."""
    diff = [f for f in GRAPH_FIELDS if not np.array_equal(getattr(a, f), getattr(b, f))]
    if diff or (a.entry_point, a.top_level) != (b.entry_point, b.top_level):
        raise AssertionError(f"{what}: the graphs differ in {diff or 'the entry point'}")


def device_build_phase(ds, gt, dev, native_recall: float) -> dict:
    """Phase 20: device_build_graph on the card at full width, its stage
    seconds and launches, its graph served as the native one is and held to
    the native graph's recall; two builds of DET_N rows bit-identical; the
    integer build equal on the CPU (twins) and the card."""
    n = DEVBUILD_N
    torch.cuda.synchronize()
    reset_launches()
    t = {}
    t0 = time.perf_counter()
    graph = device_build_graph(ds.base[:n], BUILD, device=dev, timings=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    stages = {k: t.get(k, 0.0) for k in tb.STAGES}
    log(f"[devbuild] {n} x {D} M={BUILD.M} efc={BUILD.ef_construction}: {wall:.2f} s, "
        f"{t['rounds']} rounds, {n / wall:.1f} inserts/s, top_level={graph.top_level}, "
        f"upper vertices={int((graph.levels > 0).sum())}")
    log("[devbuild]   stage seconds: " + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
        + f"; other (host, the rounds' bookkeeping) {wall - sum(stages.values()):.3f}")
    log(f"[devbuild]   kernel launches in the build: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"device build: a kernel of the path never launched: {launches}")
    graph.validate()
    if n < N:
        base_t = torch.from_numpy(ds.base[:n]).to(dev)
        gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
        gt = gt.cpu().numpy()
        del base_t
    _, recall, qps = serve(graph, ds, gt, "f32", dev, what=f"device_build {n}")
    log(f"[devbuild] recall@10 {recall:.4f} against the native graph's "
        f"{native_recall:.4f} (stated gap {DEVBUILD_GAP})")
    if recall < native_recall - DEVBUILD_GAP:
        raise AssertionError(f"device build: recall@10 {recall:.4f} more than "
                             f"{DEVBUILD_GAP} below the native {native_recall:.4f}")
    del graph
    torch.cuda.empty_cache()
    twice = [device_build_graph(ds.base[:DET_N], BUILD, device=dev) for _ in range(2)]
    _same_graph(*twice, f"two device builds of {DET_N} rows")
    log(f"[devbuild] two builds of the first {DET_N} rows: levels, lists and entry "
        f"point bit-identical")
    rows = np.random.default_rng(INT_BUILD_SET["seed"]).integers(
        -4, 5, size=(INT_BUILD_SET["n"], INT_BUILD_SET["d"])).astype(np.float32)
    _same_graph(device_build_graph(rows, INT_BUILD, device="cpu"),
                device_build_graph(rows, INT_BUILD, device=dev),
                "integer build, CPU against card")
    log(f"[devbuild] integer build {rows.shape[0]} x {rows.shape[1]} M={INT_BUILD.M}: "
        f"equal on the CPU (twins) and on the card")
    return {"n": n, "seconds": wall, "rounds": t["rounds"], "inserts_per_s": n / wall,
            "stages": stages, "launches": launches, "recall@10": recall, "qps": qps}


def build_step_check(st, rows: np.ndarray, ef: int, B_up: int, dev) -> list[dict]:
    """The build's searches on the state ``st`` for its next batch (the
    ids from ``st.count`` on, rows ``rows``), seeded by the greedy descent
    as a round seeds them: layer 0 for the whole batch over ``neighbors0``,
    and level 1 for the upper sub-batch of ``B_up`` slots (the batch's
    upper nodes, lowest ids first, -1 elsewhere, as ``plan_round`` forms
    it) over the level's (N, M) list table. On each, beam_step against
    beam_step_ref bit for bit after every step, then one step timed with
    its bound (step_timing). Returns the two cases."""
    q = torch.from_numpy(rows).to(dev)
    q_ext, bias = (-2.0 * q).contiguous(), squared_norms(q)
    nq = len(q)
    sp = SearchParams(k=ef, ef=ef, frontier=4, max_steps=2 * -(-ef // 4) + 8,
                      term="ef")
    # a level-1 node's descent walks the levels above 1 and seeds its
    # level-1 search; a layer-0 node's walks level 1 too and seeds layer 0
    ep1, ep1_d = tb._greedy_to_level(st, q_ext, bias, torch.ones(
        nq, dtype=torch.int32, device=dev), True)
    ep0, ep0_d = tb._greedy_to_level(st, q_ext, bias, torch.zeros(
        nq, dtype=torch.int32, device=dev), True)
    ids = torch.arange(st.count, st.count + nq, dtype=torch.int32, device=dev)
    is_up = st.levels[ids.long()] >= 1
    pos = torch.argsort(torch.where(is_up, ids, tb.INT32_MAX), stable=True)[:B_up]
    up_ok = is_up[pos]
    searches = (
        (0, q_ext, bias, ep0, ep0_d),
        (1, q_ext[pos].contiguous(), bias[pos].contiguous(),
         torch.where(up_ok, ep1[pos], -1), ep1_d[pos]),
    )
    cases = []
    for level, qe, b, ep, ep_d in searches:
        g = SimpleNamespace(vectors_ext=st.vectors, neighbors0=tb._level_lists(st, level),
                            row_scl=None, row_nrm=None)

        def seeded() -> list:
            return list(th._l0_state(ep[:, None].contiguous(), ep_d[:, None].contiguous(),
                                     sp))

        what = f"build level {level}"
        steps, entries = step_vs_twin(g, qe, b, seeded(), sp, what)
        log(f"[K1] beam_step on the build state after {st.count} inserts, level "
            f"{level} ({len(qe)} queries, {int(up_ok.sum()) if level else nq} taking "
            f"part, lists {tuple(g.neighbors0.shape)}): equal to beam_step_ref bit for "
            f"bit after each of the {steps} steps ({entries} beam entries)")
        case = step_timing(g, qe, b, seeded(), sp, f"{what}, {st.count} inserted")
        case.update(max_abs_err=0.0, search_steps_compared=steps, inserted=st.count,
                    level=level)
        cases.append(case)
    return cases


def online_phase(ds, dev) -> tuple[dict, list[dict]]:
    """Phase 21: DynamicHNSWIndex fed the set's first ONLINE_CAP rows in
    ONLINE_CHUNKS chunks; after each chunk its searcher serves the queries
    against the exact top-10 of the inserted prefix (on the card). After
    chunk ONLINE_STEP_CHECK the build's layer-0 and level-1 searches are
    checked on its state (build_step_check). Returns (the phase's record,
    that check's two cases)."""
    chunk = ONLINE_CAP // ONLINE_CHUNKS
    index = DynamicHNSWIndex(D, capacity=ONLINE_CAP, params=BUILD, device=dev)
    base_t = torch.from_numpy(ds.base[:ONLINE_CAP]).to(dev)
    q_t = torch.from_numpy(ds.queries).to(dev)
    chunks, launches, step_cases = [], {"beam_step": 0, "gather_score": 0}, []
    for i in range(ONLINE_CHUNKS):
        lo = i * chunk
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        index.add(ds.base[lo : lo + chunk])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        added = _launches()
        for k in launches:
            launches[k] += added[k]
        gt, _ = exact_knn(base_t[: lo + chunk], q_t, 10)
        searcher = index.searcher()
        ids, _ = searcher.search(ds.queries, SEARCH, batch_size=B)
        recall = recall_at_k(ids, gt.cpu().numpy(), 10)
        log(f"[online] chunk {i + 1}: {chunk} inserts in {sec:.2f} s ({chunk / sec:.1f} "
            f"inserts/s), {index.count} in the index, launches {added}; searcher "
            f"recall@10 {recall:.4f} against the exact top-10 of the prefix")
        chunks.append({"inserted": index.count, "seconds": sec,
                       "inserts_per_s": chunk / sec, "recall@10": recall,
                       "launches": added})
        if recall < ONLINE_MIN_RECALL:
            raise AssertionError(f"online index: recall@10 {recall:.4f} < "
                                 f"{ONLINE_MIN_RECALL} after {index.count} inserts")
        if min(added.values()) == 0:
            raise AssertionError(f"online index: a kernel never launched: {added}")
        if i + 1 == ONLINE_STEP_CHECK:
            B_up = -(-tb.upper_batch(index.batch_size, BUILD.M) // 8) * 8
            step_cases = build_step_check(
                index.st, ds.base[index.count : index.count + index.batch_size],
                BUILD.ef_construction, B_up, dev)
        del searcher
    del index, base_t
    torch.cuda.empty_cache()
    return {"chunks": chunks, "launches": launches}, step_cases


# --- phase 23: the IVF family at full width --------------------------------------

IVF_SEED = 1234
IVF_PROBES = (16, 32, 64)  # search on the fine layout: recall must not fall
IVF_E2E_PROBES = 32  # the CPU-against-card check and the probe-chunk identity
IVF_PROBE_CHUNK = 4
# full probes: the set's first IVF_FULL_N rows in IVF_FULL_C clusters, every
# cluster probed, must find the exact top-10 (the JAX package's
# test_ivf_search_exact_full_probes_large_c on the chunked path)
IVF_FULL_N, IVF_FULL_C, IVF_FULL_QUERIES, IVF_FULL_MIN_RECALL = 65_536, 512, 1_000, 0.99
# search_routed: the command line's defaults and bench.py's point
IVF_ROUTES = (("cli", {"probes": 16, "shared": 96, "tile": 256}),
              ("bench", {"probes": 16, "shared": 128, "tile": 64}))
IVF_DEVICE_RECALL_GAP = 0.02  # from_device draws other samples, same semantics


def _ivf_layout_check(index: IVFIndex, n: int, what: str, C: int | None = None) -> None:
    """The auto cluster count (C, default the fine layout's ceil(n/128)) and
    cap = ceil(1.25 n / C); every id exactly once, no cluster over cap, pads
    -1 with +inf norms and zero rows (on the card)."""
    data = index.data
    C = C or -(-n // 128)
    if (data.num_clusters, data.cap) != (C, math.ceil(1.25 * n / C)):
        raise AssertionError(f"ivf {what}: C={data.num_clusters} cap={data.cap}")
    ids = data.block_ids
    real = ids >= 0
    every_once = torch.equal(torch.sort(ids[real]).values,
                             torch.arange(n, dtype=ids.dtype, device=ids.device))
    per = int(real.sum(dim=1).max())
    pads_ok = bool(torch.isinf(data.block_sq[~real]).all()
                   and (data.blocks[~real] == 0).all()
                   and torch.isfinite(data.block_sq[real]).all())
    log(f"[ivf] {what}: C={data.num_clusters} cap={data.cap} fullest cluster {per}, "
        f"every id once {every_once}, pads -1/+inf/zero {pads_ok}")
    if not (every_once and per <= data.cap and pads_ok):
        raise AssertionError(f"ivf {what}: layout invariants broken")


def _ivf_timed(run) -> tuple[tuple, float]:
    """(``run()``'s result, its CUDA-synchronised seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ivf_build(what: str, build) -> tuple[IVFIndex, dict]:
    timings = {}
    index, wall = _ivf_timed(lambda: build(timings))
    log(f"[ivf] {what}: {wall:.2f} s, stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()))
    return index, {"seconds": wall, "stages": timings, "C": index.data.num_clusters,
                   "cap": index.data.cap}


def _ivf_search(index: IVFIndex, ds, gt, probes: int, what: str) -> dict:
    """All queries at batch B after a warm-up batch: recall@10 and QPS."""
    index.search(ds.queries[:B], 10, probes=probes, batch_size=B)
    (ids, _), wall = _ivf_timed(
        lambda: index.search(ds.queries, 10, probes=probes, batch_size=B))
    recall = recall_at_k(ids, gt, 10)
    log(f"[ivf] {what} search probes={probes}: recall@10={recall:.4f} "
        f"qps={NQ / wall:.1f} wall={wall:.3f} s")
    return {"recall": recall, "qps": NQ / wall}


def _ivf_routed(index: IVFIndex, ds, gt, knobs: dict, what: str) -> dict:
    index.search_routed(ds.queries[:B], 10, **knobs)
    (ids, _, st), wall = _ivf_timed(
        lambda: index.search_routed(ds.queries, 10, with_stats=True, **knobs))
    recall = recall_at_k(ids, gt, 10)
    log(f"[ivf] {what} search_routed {knobs}: recall@10={recall:.4f} "
        f"qps={NQ / wall:.1f} wall={wall:.3f} s coverage={st['probe_coverage']:.4f} "
        f"spilled={st['fallback_queries']} tiles={st['tiles']}")
    return {"recall": recall, "qps": NQ / wall, "coverage": st["probe_coverage"],
            "spilled": st["fallback_queries"]}


def ivf_phase(ds, gt, dev) -> dict:
    """Phase 23: IVFIndex on the 1M set, built on the host (fine and routed
    layouts) and on the card (from_device); every check raises. Returns
    the numbers the [ivf] summary line carries."""
    t_phase = time.perf_counter()
    out = {}
    fine, out["fine_build"] = _ivf_build("fine layout, host build", lambda tm: IVFIndex(
        ds.base, seed=IVF_SEED, device=dev, timings=tm))
    _ivf_layout_check(fine, N, "fine layout")
    served = {p: _ivf_search(fine, ds, gt, p, "fine") for p in IVF_PROBES}
    recalls = [served[p]["recall"] for p in IVF_PROBES]
    if recalls != sorted(recalls):
        raise AssertionError(f"ivf fine: recall falls as probes rise: {recalls}")
    out["fine"] = served

    # the card against the CPU on the same layout; the probe chunk's identity
    q = ds.queries[:E2E_QUERIES]
    cpu = IVFIndex.from_layout(IVFData(*(t.cpu() for t in fine.data)), "l2")
    a_ids, a_d = cpu.search(q, 10, probes=IVF_E2E_PROBES, batch_size=E2E_QUERIES)
    b_ids, b_d = fine.search(q, 10, probes=IVF_E2E_PROBES, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, f"ivf fine probes={IVF_E2E_PROBES}", FLAT_ATOL)
    del cpu
    q_dev = torch.from_numpy(ds.queries[:B]).to(dev)
    kw = dict(k=10, p=IVF_E2E_PROBES, metric=METRIC_L2)
    a, b = (ivf_search(fine.data, q_dev, **kw),
            ivf_search(fine.data, q_dev, probe_chunk=IVF_PROBE_CHUNK, **kw))
    same = torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                   b[1].view(torch.int32))
    log(f"[ivf] probe_chunk={IVF_PROBE_CHUNK} against the default chunk, probes="
        f"{IVF_E2E_PROBES}, one batch of {B}: bit for bit {same}")
    if not same:
        raise AssertionError("ivf: the probe chunk changed the results")
    del q_dev, a, b

    # what --index ivf --ivf-routed serves: search_routed on the fine layout
    out["fine_routed_cli"] = _ivf_routed(fine, ds, gt, dict(IVF_ROUTES)["cli"],
                                         "fine layout")
    profile_run(lambda: fine.search(ds.queries[:B], 10, probes=IVF_E2E_PROBES,
                                    batch_size=B), f"ivf search probes={IVF_E2E_PROBES}")
    fine_recall32 = served[IVF_E2E_PROBES]["recall"]
    del fine
    torch.cuda.empty_cache()

    # full probes scan everything: the exact top-10 of a subset
    sub = ds.base[:IVF_FULL_N]
    qf = ds.queries[:IVF_FULL_QUERIES]
    sub_gt = exact_knn(torch.from_numpy(sub).to(dev), torch.from_numpy(qf).to(dev),
                       10)[0].cpu().numpy()
    full, _ = _ivf_build(f"{IVF_FULL_N} rows, C={IVF_FULL_C}", lambda tm: IVFIndex(
        sub, num_clusters=IVF_FULL_C, seed=IVF_SEED, device=dev, timings=tm))
    (ids, _), wall = _ivf_timed(lambda: full.search(qf, 10, probes=IVF_FULL_C, rerank=8))
    out["full_probes_recall"] = recall_at_k(ids, sub_gt, 10)
    log(f"[ivf] full probes ({IVF_FULL_C} of {IVF_FULL_C}, rerank 8, "
        f"{IVF_FULL_QUERIES} queries): recall@10={out['full_probes_recall']:.4f} "
        f"wall={wall:.3f} s")
    if out["full_probes_recall"] < IVF_FULL_MIN_RECALL:
        raise AssertionError(f"ivf full probes: recall {out['full_probes_recall']}")
    del full

    # the routed layout (C <= 2048)
    routed, out["routed_build"] = _ivf_build("routed layout, host build", lambda tm: IVFIndex(
        ds.base, seed=IVF_SEED, layout="routed", device=dev, timings=tm))
    _ivf_layout_check(routed, N, "routed layout", min(2048, -(-N // 128)))
    out["routed"] = {r: _ivf_routed(routed, ds, gt, knobs, "routed layout")
                     for r, knobs in IVF_ROUTES}
    per_query = routed.search(ds.queries, 10, probes=16)
    spilled = routed.search_routed(ds.queries, 10, probes=16, shared=96, tile=256,
                                   fallback=1.1, with_stats=True)
    same = np.array_equal(spilled[0], per_query[0])
    log(f"[ivf] routed layout, fallback=1.1 ({spilled[2]['fallback_queries']} spilled) "
        f"against search probes=16: ids equal {same} (in "
        f"{(spilled[0] == per_query[0]).mean():.6f} of positions), dists bit for bit "
        f"{np.array_equal(spilled[1].view(np.uint32), per_query[1].view(np.uint32))}")
    if not same or spilled[2]["fallback_queries"] != NQ:
        raise AssertionError("ivf: the fallback spill is not the per-query search")
    profile_run(lambda: routed.search_routed(ds.queries[:B], 10, **dict(IVF_ROUTES)["cli"]),
                "ivf search_routed, routed layout, the CLI's knobs")
    del routed, per_query, spilled
    torch.cuda.empty_cache()

    # the build that keeps the rows on the card
    v_dev = torch.from_numpy(ds.base).to(dev)
    on_card, out["device_build"] = _ivf_build("fine layout, from_device", lambda tm: (
        IVFIndex.from_device(v_dev, seed=IVF_SEED, device=dev, timings=tm)))
    _ivf_layout_check(on_card, N, "from_device")
    out["device"] = _ivf_search(on_card, ds, gt, IVF_E2E_PROBES, "from_device")
    if abs(out["device"]["recall"] - fine_recall32) > IVF_DEVICE_RECALL_GAP:
        raise AssertionError(f"ivf from_device: recall {out['device']['recall']} "
                             f"against the host build's {fine_recall32}")
    del on_card, v_dev
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[ivf] phase 23: {out['seconds']:.1f} s")
    log(f"[ivf] summary {json.dumps(out)}")
    return out


# --- phase 22: the command line at full width ----------------------------------

# the runs' shared flags, and the HNSW ones: phase 5's build and search
CLI_COMMON = ["-k", "10", "--batch", str(B)]
CLI_HNSW = ["-m", str(BUILD.M), "--ef-construction", str(BUILD.ef_construction),
            "--ef-search", str(SEARCH.ef), "--frontier", str(SEARCH.frontier)]
CLI_MIN_RECALL = 0.90  # split, routed, the device build: broken, not mistuned
CLI_FLAT_QUERIES = 1_000
CLI_DEVBUILD = ["--synthetic", "65536:128", "--num-queries", "1000"]
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def _all_launches() -> dict[str, int]:
    """Each kernel wrapper's launches since reset_launches, those above 0."""
    counts = {"gather_score": gather_score.launches,
              "beam_step": bs.beam_step.launches,
              "routed_classmax_scan": k4.routed_classmax_scan.launches}
    for forms in (K2_FORMS, K3_FUNCS, K56_FORMS):
        counts.update({name: f[0].launches for name, f in forms.items()})
    return {k: v for k, v in counts.items() if v}


def run_cli(argv: list[str], what: str) -> tuple[dict, dict, str]:
    """``shine_tpu_torch.cli.main(argv)`` in this process, its output
    captured: (the Statistics document of its last stdout line, each
    kernel's launches during the run, its stderr); logs one [cli] line."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = _all_launches()
    if rc != 0:
        raise AssertionError(f"cli {what}: exit status {rc}: {err.getvalue()}")
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    q = doc["queries"]
    log(f"[cli] {what}: build_ms={doc['build']['build_time_ms']} "
        f"qps={q['queries_per_sec']} recall={q['recall']} "
        f"queries={q['num_queries']} expansions={q['expansions']} "
        f"distance_computations={q['distance_computations']} "
        f"scanned_rows={q['scanned_rows']} steps={q['traversal_steps']} "
        f"hbm_gather_bytes={q['hbm_gather_bytes']} timings={doc['timings']} "
        f"device={doc['meta']['device']!r} launches={launches} wall={wall:.2f} s")
    torch.cuda.empty_cache()
    return doc, launches, err.getvalue()


def _library_flat(ds, gt, dev) -> tuple[float, float]:
    """The port's FlatIndex on the first CLI_FLAT_QUERIES queries, as the
    CLI's flat run serves them: (recall@10, QPS after a warm-up pass)."""
    index = FlatIndex(ds.base, device=dev)
    q = ds.queries[:CLI_FLAT_QUERIES]
    index.search(q, 10, batch_size=B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = index.search(q, 10, batch_size=B)
    torch.cuda.synchronize()
    qps = CLI_FLAT_QUERIES / (time.perf_counter() - t0)
    del index
    torch.cuda.empty_cache()
    return recall_at_k(ids, gt[:CLI_FLAT_QUERIES], 10), qps


def cli_phase(ds, gt, graph_path: str, data_dir: str, want: dict, dev) -> dict:
    """Phase 22: the command line, in process, from the set and phase 5's
    graph saved under ``data_dir`` and at ``graph_path``. ``want`` maps a
    run to (its recall rule, the library run's QPS at the same knobs, that
    run's phase): ("eq", r) asks for recall r exactly, ("ge", r) for at
    least r. Each run must launch its kernels. Returns each run's
    numbers."""
    t_phase = time.perf_counter()
    flat_recall, flat_qps = _library_flat(ds, gt, dev)
    want = dict(want, flat=(("eq", flat_recall), flat_qps, "22, FlatIndex.search"))
    data = ["--data-path", data_dir, *CLI_COMMON]
    runs = (  # (name, argv, kernels that must launch)
        ("hnsw", data + ["--index", "hnsw", "--load-index", graph_path, *CLI_HNSW],
         ("beam_step",)),
        ("hnsw_scan_build", data + ["--index", "hnsw", "--fast-build", *CLI_HNSW],
         ("classmax2_scan",)),
        ("fastflat", data + ["--index", "fastflat"], ("classmax_scan",)),
        ("split", data + ["--index", "split"], ("classmax_scan_split",)),
        ("routed", data + ["--index", "routed", "--probes", "0"],
         ("routed_classmax_scan",)),
        ("auto_zipf", data + ["--index", "auto", "--zipf", "1.0", "--warmup", "1000"],
         ("classmax_scan",)),
        ("flat", data + ["--index", "flat", "--num-queries", str(CLI_FLAT_QUERIES)],
         ()),
        ("hnsw_device_build", CLI_DEVBUILD + CLI_COMMON
         + ["--index", "hnsw", "--device-build", *CLI_HNSW],
         ("beam_step", "gather_score")),
        ("ivf", data + ["--index", "ivf", "--probes", str(IVF_E2E_PROBES),
                        "--seed", str(IVF_SEED)], ()),
        ("ivf_routed", data + ["--index", "ivf", "--ivf-routed", "--seed",
                               str(IVF_SEED)], ()),
    )
    out = {}
    for name, argv, kernels in runs:
        doc, launches, err = run_cli(argv, name)
        q = doc["queries"]
        rule, lib_qps, lib_phase = want[name]
        if lib_qps is not None:
            log(f"[cli]   {name}: {q['queries_per_sec']:.1f} QPS against "
                f"{lib_qps:.1f} for the library call at the same knobs (phase "
                f"{lib_phase}): {q['queries_per_sec'] / lib_qps:.3f}x")
        kind, value = rule
        ok = q["recall"] == value if kind == "eq" else q["recall"] >= value
        if not ok:
            raise AssertionError(f"cli {name}: recall@10 {q['recall']} against "
                                 f"{kind} {value}")
        missing = [k for k in kernels if not launches.get(k)]
        if missing:
            raise AssertionError(f"cli {name}: {missing} never launched")
        if name.startswith("ivf") and launches:
            raise AssertionError(f"cli {name}: IVF launched {launches}")
        if name == "auto_zipf" and "-> fastflat" not in err:
            raise AssertionError(f"cli auto: resolved otherwise: {err.strip()}")
        out[name] = {"argv": argv, "build": doc["build"], "queries": q,
                     "timings": doc["timings"], "launches": launches,
                     "library_qps": lib_qps}
    log(f"[cli] phase 22: {time.perf_counter() - t_phase:.1f} s")
    log(f"[cli] summary {json.dumps(out)}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    check_precision()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # g++ builds the graph builder while nvcc builds the kernels
        gxx = pool.submit(native.load)
        _build.load()
        log(f"[build] kernel library {_build.lib_path()}: nvcc "
            f"{_build.build_seconds:.2f} s" if _build.build_seconds is not None
            else f"[build] kernel library {_build.lib_path()}: already built")
        for line in _build.build_log.splitlines():  # registers and spills
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
        gxx.result()
    log(f"[build] native builder {native.lib_path()}: ready after "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    log(f"[data] {N} x {D}, {NQ} queries: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    flat = FastFlatIndex(ds.base, device=dev)
    torch.cuda.synchronize()
    log(f"[flat] FastFlatIndex build (shuffle, pack {tuple(flat.ext.shape)} "
        f"on the card): {time.perf_counter() - t0:.2f} s")
    plan = flat_route_plan(flat)
    shapes: dict[int, list[int]] = {}
    for cls, kb in [(p[3], p[4]) for p in plan] + list(K2_SHAPES):
        if kb not in shapes.setdefault(cls, []):
            shapes[cls].append(kb)

    k1_cases = kernel_vs_twin(ds.base, ds.queries, dev)
    k2_cases, library_ms = k2_vs_twin(ds.base, ds.queries, dev, shapes)

    threads = min(os.cpu_count() or 1, 32)
    t0 = time.perf_counter()
    graph = build_graph(ds.base, BUILD, threads=threads)
    build_s = time.perf_counter() - t0
    log(f"[hnsw] native build M={BUILD.M} efc={BUILD.ef_construction} "
        f"threads={threads}: {build_s:.2f} s, top_level={graph.top_level}, "
        f"upper vertices={int((graph.levels > 0).sum())}")
    t0 = time.perf_counter()
    base_t = torch.from_numpy(ds.base).to(dev)
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    torch.cuda.synchronize()
    gt = gt.cpu().numpy()
    del base_t
    log(f"[hnsw] exact fp32 ground truth on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    step_launches = 0
    native_served = {}
    for rows in ("f32", "bf16"):
        launches, recall, qps = serve(graph, ds, gt, rows, dev)
        step_launches += launches
        native_served[rows] = (recall, qps)
        torch.cuda.empty_cache()
    step_cases, descent = beam_step_phase(graph, ds, gt, dev)
    hnsw_end_to_end(graph, ds, dev)
    # phase 22 serves this graph and the set from files
    os.makedirs(BUILD_DIR, exist_ok=True)
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=BUILD_DIR)
    graph_path = os.path.join(cli_dir, "native.npz")
    t0 = time.perf_counter()
    save_graph(graph, graph_path)
    log(f"[cli] native graph saved: {time.perf_counter() - t0:.2f} s")
    del graph
    torch.cuda.empty_cache()

    k2_launches, flat_served = serve_flat(flat, ds, gt, plan)
    profile_batch(flat, ds.queries, "fastflat auto")
    flat_end_to_end(ds, flat)
    k56_cases, k56_library_ms = blockmax_vs_twin(ds.base, ds.queries, dev)
    blockmax_served = serve_blockmax(flat, ds, gt)
    del flat
    torch.cuda.empty_cache()
    builds = build_phases(ds, gt, dev)
    log(f"[build] native graph (phase 5), f32: recall@10={native_served['f32'][0]:.4f} "
        f"qps={native_served['f32'][1]:.1f} after {build_s:.2f} s of build")
    small_build_cpu_vs_card(dev)
    devbuild = device_build_phase(ds, gt, dev, native_served["f32"][0])
    online, build_step = online_phase(ds, dev)
    k3_kernels, split_served = split_phases(ds, gt, dev)
    try:
        ivf = ivf_phase(ds, gt, dev)
        ds.ground_truth = gt  # the exact top-10 on the card
        data_dir = os.path.join(cli_dir, "sift_shape")
        t0 = time.perf_counter()
        save_dataset(ds, data_dir)
        log(f"[cli] set saved: {time.perf_counter() - t0:.2f} s")
        cli_phase(ds, gt, graph_path, data_dir, {
            "hnsw": (("eq", native_served["f32"][0]), native_served["f32"][1], 5),
            "hnsw_scan_build": (("eq", builds["pool0"]["recall@10"]),
                                builds["pool0"]["qps"], "16, pool 0"),
            "fastflat": (("eq", flat_served["auto"][0]), flat_served["auto"][1],
                         "7, auto"),
            "split": (("ge", CLI_MIN_RECALL), split_served[("int8", "auto")][1],
                      "10, int8 auto"),
            "routed": (("ge", CLI_MIN_RECALL), None, None),
            "auto_zipf": (("ge", FLAT_MIN_RECALL), flat_served["auto"][1], "7, auto"),
            "hnsw_device_build": (("ge", CLI_MIN_RECALL), None, None),
            "ivf": (("eq", ivf["fine"][IVF_E2E_PROBES]["recall"]),
                    ivf["fine"][IVF_E2E_PROBES]["qps"], f"23, probes {IVF_E2E_PROBES}"),
            "ivf_routed": (("eq", ivf["fine_routed_cli"]["recall"]),
                           ivf["fine_routed_cli"]["qps"],
                           "23, search_routed on the fine layout"),
        }, dev)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    del ds, gt
    k4_kernels = routed_phases(dev)

    main_k1 = k1_cases[0]  # f32 rows, L2: the HNSW slice's own row type
    main_step = step_cases[0]
    kernels = [{
        "name": "beam_step",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": step_launches,
        "max_abs_err": max(c["max_abs_err"] for c in step_cases),
        "ms": main_step["ms"],
        "plain_ms": main_step["plain_ms"],
        "bound_ms": main_step["bound_ms"],
        "bound_by": main_step["bound_by"],
        "library_ms": None,
        "note": ("one layer-0 step of the JAX loop body (pallas_gather.py's row "
                 "gather, the scoring, beam_merge); launches: phase 5's f32 and "
                 "bf16 passes, gated no-ops included; times: one mid-search step "
                 "at B=4096"),
        "cases": step_cases,
        "build_launches": {"device_build": devbuild["launches"]["beam_step"],
                           "online": online["launches"]["beam_step"]},
        "build_step": build_step[0],
        "build_step_upper": build_step[1],
    }, {
        "name": "gather_score",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": descent["gather_score_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
        "ms": main_k1["ms"],
        "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"],
        "bound_by": main_k1["bound_by"],
        "library_ms": None,
        "note": ("launches: the descent entry's pass (its greedy walk and first "
                 "distance); the dense entry's path runs beam_step alone"),
        "cases": k1_cases,
        "build_launches": {"device_build": devbuild["launches"]["gather_score"],
                           "online": online["launches"]["gather_score"]},
    }]
    for route, _, name, cls, kb in plan:
        # the numbers at the shape whose launches the entry reports
        kb = kb if "topk" in name else None
        at = [c for c in k2_cases[name] if (c["cls"], c["kb"]) == (cls, kb)]
        main_k2 = next(c for c in at if c["metric"] == "l2")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
            "replaces": K2_FORMS[name][2],
            "launches": k2_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in at),
            "ms": main_k2["ms"],
            "plain_ms": main_k2["plain_ms"],
            "bound_ms": main_k2["bound_ms"],
            "bound_by": main_k2["bound_by"],
            "library_ms": library_ms,
            "flat_route": route,
            "cls": cls,
            "kb": kb,
            "cases": k2_cases[name],
        })
    for name, (_, _, replaces, source) in K56_FORMS.items():
        main_k56 = next(c for c in k56_cases[name] if c["metric"] == "l2")
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": blockmax_served["launches"] if name == "blockmax_scan" else 0,
            "max_abs_err": max(c["max_abs_err"] for c in k56_cases[name]),
            "ms": main_k56["ms"],
            "plain_ms": main_k56["plain_ms"],
            "bound_ms": main_k56["bound_ms"],
            "bound_by": main_k56["bound_by"],
            "library_ms": k56_library_ms,
            "build_launches": {b: builds[b]["launches"].get(name, 0) for b in builds},
            "cases": k56_cases[name],
        }
        if name == "blockmax_scan":
            entry.update({"flat_route": "blockmax", "kb": blockmax_served["kb"],
                          "recall@10": blockmax_served["recall@10"],
                          "qps": blockmax_served["qps"]})
        else:
            entry["note"] = ("no path of the JAX package calls blockmax_scan2 (only its "
                             "own test does), so no path of the port launches it: 0 on "
                             "every served path; held against its twin in phase 14")
        kernels.append(entry)
    kernels += k3_kernels + k4_kernels
    for k in kernels:  # the class-max sweeps of the builds
        if k["name"] in K2_FORMS:
            k["build_launches"] = {b: builds[b]["launches"].get(k["name"], 0)
                                   for b in builds}
    log(f"[build] summary {json.dumps(builds)}")
    log(f"[devbuild] summary {json.dumps({'device_build': devbuild, 'online': online})}")
    log(f"[total] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
