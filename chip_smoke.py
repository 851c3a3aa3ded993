"""Run the PyTorch port's main paths once on a CUDA card, and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; builds everything from this checkout
into build/ (the CUDA kernels, one nvcc per source, all at once, beside
the native graph builder's g++). Phases, on one SIFT1M-shaped synthetic
set (1M x 128, 10,000 queries, L2, seed 7), generated once:

  1. device: the card's name and power limit; the fp32 precision lock;
  2. build: compile and load the kernel library and the native builder;
  3. K1 against its plain twin: gather_score on the HNSW slice's shapes
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
     k=10, ef=96, frontier=8 at batch 4096 on f32 rows, then bf16 rows;
     recall@10 against an exact fp32 brute force on the card;
  6. HNSW end to end: 256 queries on the CPU (twins) and the card;
  7. FastFlatIndex: all queries at batch 4096 through each of the four
     scan routes (the auto knobs, bench's keep2 point, keep2 at kb=64,
     kb=16), recall@10 against the same ground truth, QPS after a
     warm-up batch, each kernel's launches;
  8. FastFlatIndex end to end: 256 queries on the CPU and the card, at
     the auto knobs and the keep2 point.

Every count of kernel launches is set to 0 just before the run it reads.
Each kernel's entry in the JSON table pairs those launches with the time,
error and bound taken at the shape its route ran. Any failure raises. On
success the last line is
{"ok": true, "device": {"platform": "gpu", ...}}; the line before it holds
nvidia-smi's name and power limit, and the one before that the kernel
table as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from shine_tpu_torch import FastFlatIndex, HNSWIndex, native
from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.graph.soa import build_graph
from shine_tpu_torch.io import recall_at_k, synthetic_dataset
from shine_tpu_torch.models.hnsw import _extend_query, quantize_rows
from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops.distance import check_precision, exact_knn
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table

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
    for fn, _, _ in K2_FORMS.values():
        fn.launches = 0


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


def serve(graph, ds, gt, rows: str, dev) -> int:
    """Search all queries on ``rows`` rows; check recall and the kernel's
    launches in that run, and return the launch count."""
    t0 = time.perf_counter()
    index = HNSWIndex(graph, rows=rows, device=dev)
    torch.cuda.synchronize()
    log(f"[hnsw] upload {rows} rows: {time.perf_counter() - t0:.2f} s")
    index.search(ds.queries[:B], SEARCH, batch_size=B)  # warm-up batch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gather_score.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[hnsw] {rows}: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s mean_hops={index.last_hops / NQ:.2f} "
        f"mean_dist_comps={index.last_dists / NQ:.1f} "
        f"beam_steps={index.last_steps} kernel_launches={launches}")
    if recall < MIN_RECALL:
        raise AssertionError(f"{rows}: recall@10 {recall:.4f} < {MIN_RECALL}")
    if launches < index.last_steps or launches == 0:
        raise AssertionError(
            f"{rows}: {launches} kernel launches for {index.last_steps} beam steps")
    return launches


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


def serve_flat(index: FastFlatIndex, ds, gt, plan) -> dict[str, int]:
    """All queries through each scan route; returns each route's kernel
    launches, checked non-zero, with recall and QPS logged."""
    launches = {}
    pre = index.preload(ds.queries, batch_size=B)
    for route, knobs, kernel, cls, kb in plan:
        index.search(ds.queries[:B], 10, batch_size=B, **knobs)  # warm-up
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
    return launches


def flat_end_to_end(ds, gpu: FastFlatIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = FastFlatIndex(ds.base, device="cpu")
    for route, knobs in FLAT_ROUTES[:2]:
        a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        _compare(a_ids, a_d, b_ids, b_d, f"fastflat {route}", FLAT_ATOL)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    dev = torch.device("cuda:0")
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
    k1_launches = 0
    for rows in ("f32", "bf16"):
        k1_launches += serve(graph, ds, gt, rows, dev)
        torch.cuda.empty_cache()
    hnsw_end_to_end(graph, ds, dev)
    del graph
    torch.cuda.empty_cache()

    k2_launches = serve_flat(flat, ds, gt, plan)
    flat_end_to_end(ds, flat)

    main_k1 = k1_cases[0]  # f32 rows, L2: the HNSW slice's own row type
    kernels = [{
        "name": "gather_score",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": k1_launches,
        "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
        "ms": main_k1["ms"],
        "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"],
        "bound_by": main_k1["bound_by"],
        "library_ms": None,
        "cases": k1_cases,
    }]
    for route, _, name, cls, kb in plan:
        # the numbers at the shape whose launches the entry reports
        kb = kb if "topk" in name else None
        at = [c for c in k2_cases[name] if (c["cls"], c["kb"]) == (cls, kb)]
        main_k2 = next(c for c in at if c["metric"] == "l2")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/classmax_scan.cu",
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
