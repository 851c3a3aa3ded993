"""Run the PyTorch port's HNSW query path once on a CUDA card, and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; builds everything from this checkout
(the CUDA kernel into build/, the native graph builder beside its source).
Phases:

  1. device: the card's name and power limit; the fp32 precision lock;
  2. build: compile and load the kernel library;
  3. kernel against its plain twin: gather_score on the slice's shapes
     (B=4096 queries, K=256 candidate lanes, d=128, N=1M rows) for f32,
     bf16 and int8 rows under L2 and IP, ~10% masked lanes; CUDA-event
     timings of both;
  4. the slice: a SIFT1M-shaped synthetic set (1M x 128, 10,000 queries,
     L2), the native build at M=16, ef_construction=200, search with
     k=10, ef=96, frontier=8 at batch 4096 on f32 rows, then bf16 rows;
     recall@10 against an exact fp32 brute force on the card;
  5. end to end against the plain path: the first 256 queries searched
     with the graph on the CPU (plain twins) and on the card (kernel).

Any failure raises. On success the last line is
{"ok": true, "device": {"platform": "gpu", ...}}; the line before it holds
nvidia-smi's name and power limit, and the one before that the kernel
table as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph.soa import build_graph
from shine_tpu.io import recall_at_k, synthetic_dataset
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.models.hnsw import _extend_query, quantize_rows
from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops.distance import check_precision, exact_knn
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
B, K = 4096, 256  # bench batch; E * 2M = 8 * 32 candidate lanes per step
BUILD = HNSWParams(M=16, ef_construction=200)
SEARCH = SearchParams(k=10, ef=96, frontier=8)
RTOL, ATOL = 1e-5, 1e-3  # distances are O(1e3); the two sum in other orders
MIN_RECALL = 0.90
E2E_QUERIES, MIN_OVERLAP = 256, 0.99


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(3):
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
            cases.append(dict(rows=rows, metric=metric, max_abs_err=err,
                              ms=ms, plain_ms=plain_ms))
            log(f"[kernel] {rows:4s} {metric}: max_abs_err={err:.3e} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del vectors, tables
    return cases


def serve(graph, ds, gt, rows: str, dev) -> int:
    """Search all queries on ``rows`` rows; check recall and the kernel's
    launches in that run, and return the launch count."""
    t0 = time.perf_counter()
    index = HNSWIndex(graph, rows=rows, device=dev)
    torch.cuda.synchronize()
    log(f"[slice] upload {rows} rows: {time.perf_counter() - t0:.2f} s")
    index.search(ds.queries[:B], SEARCH, batch_size=B)  # warm-up batch
    torch.cuda.synchronize()
    gather_score.launches = 0
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gather_score.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[slice] {rows}: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s mean_hops={index.last_hops / NQ:.2f} "
        f"mean_dist_comps={index.last_dists / NQ:.1f} "
        f"beam_steps={index.last_steps} kernel_launches={launches}")
    if recall < MIN_RECALL:
        raise AssertionError(f"{rows}: recall@10 {recall:.4f} < {MIN_RECALL}")
    if launches < index.last_steps or launches == 0:
        raise AssertionError(
            f"{rows}: {launches} kernel launches for {index.last_steps} beam steps")
    return launches


def end_to_end(graph, ds, dev) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = HNSWIndex(graph, rows="f32", device="cpu")
    a_ids, a_d = cpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    gpu = HNSWIndex(graph, rows="f32", device=dev)
    b_ids, b_d = gpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    overlap = recall_at_k(b_ids, a_ids, 10)
    same = a_ids[:, :, None] == b_ids[:, None, :]  # (Q, k, k) id matches
    qi, ai, bi = np.nonzero(same)
    da, db = a_d[qi, ai], b_d[qi, bi]
    err = float(np.abs(da - db).max())
    log(f"[e2e] {E2E_QUERIES} queries cpu vs cuda: id overlap={overlap:.4f} "
        f"matched={len(qi)} max_abs_dist_err={err:.3e}")
    if overlap < MIN_OVERLAP:
        raise AssertionError(f"cpu/cuda id overlap {overlap:.4f} < {MIN_OVERLAP}")
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    check_precision()

    _build.load()
    log(f"[build] kernel library {_build.lib_path()}: nvcc "
        f"{_build.build_seconds:.2f} s" if _build.build_seconds is not None
        else f"[build] kernel library {_build.lib_path()}: already built")

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    log(f"[data] {N} x {D}, {NQ} queries: {time.perf_counter() - t0:.2f} s")
    cases = kernel_vs_twin(ds.base, ds.queries, dev)

    threads = min(os.cpu_count() or 1, 32)
    t0 = time.perf_counter()
    graph = build_graph(ds.base, BUILD, threads=threads)
    build_s = time.perf_counter() - t0
    log(f"[slice] native build M={BUILD.M} efc={BUILD.ef_construction} "
        f"threads={threads}: {build_s:.2f} s, top_level={graph.top_level}, "
        f"upper vertices={int((graph.levels > 0).sum())}")
    t0 = time.perf_counter()
    base_t = torch.from_numpy(ds.base).to(dev)
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    torch.cuda.synchronize()
    gt = gt.cpu().numpy()
    del base_t
    log(f"[slice] exact fp32 ground truth on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    launches = {}
    for rows in ("f32", "bf16"):
        launches[rows] = serve(graph, ds, gt, rows, dev)
        torch.cuda.empty_cache()
    end_to_end(graph, ds, dev)

    main_case = cases[0]  # f32 rows, L2: the slice's own row type
    print(json.dumps({"kernels": [{
        "name": "gather_score",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": launches["f32"] + launches["bf16"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "cases": cases,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
