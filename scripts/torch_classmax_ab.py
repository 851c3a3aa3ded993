"""Time the scan kernels of two checkouts of the PyTorch port in one
process, on one CUDA card, in turns: the class-max scans K2 and K3, the
block-max scans K5 and K6, and the routed scan K4.

    python scripts/torch_classmax_ab.py --base DIR [--reps 10]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``). Each checkout's ``csrc`` is built into its
own library by its own ``shine_tpu_torch.ops._build``; the tables and
queries are this checkout's. K2, K3 and K5 run at chip_smoke.py's 1M x 128
shapes (B=4096, cls=2048: K2 keep1 and keep2, K3 bf16 and int8, keep1 and
keep2, K5 on K2's table); K6 on K2's table with integer rows and queries.
K4 runs at chip_smoke.py's routed-4m shapes: the index built from the
4,194,304 x 128 set at the command line's defaults, and each routed route's
own launch (the auto knobs at T=64, tile=32 at T=32, the starved route's
T=16 spill) with its columns from the routing of the set's queries; the
index's int8 table and that table widened to bf16, with integer queries in
place of the set's, so that every product sum is exact. The two libraries
run in the order base, this, this, base, each timed as the median of
``--reps`` CUDA-event timings after a warm-up, and their outputs must agree
bit for bit (as int32 words). Prints one JSON line a form and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops import _build  # noqa: E402
from shine_tpu_torch.ops import blockmax as bm  # noqa: E402
from shine_tpu_torch.ops import classmax as cm  # noqa: E402
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table  # noqa: E402
from shine_tpu_torch.ops import scan_routed as k4  # noqa: E402
from shine_tpu_torch.ops.scan_split import (  # noqa: E402
    SPLIT_QUANTUM,
    pack_split_query,
    pack_split_tables,
)

N, D, B, CLS = 1_000_000, 128, 4096, 2048
_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")


def bind_entries(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the K2, K3 and K5 entry points bound (their C signatures
    are the same in every checkout that has them)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.shine_classmax_scan.restype = i32
    lib.shine_classmax_scan.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp, vp, vp, vp]
    lib.shine_classmax_scan_split.restype = i32
    lib.shine_classmax_scan_split.argtypes = [vp, i32, vp, vp, i64, i32, i32, i32, i32,
                                              vp, vp, vp, vp, vp]
    lib.shine_blockmax_scan.restype = i32
    lib.shine_blockmax_scan.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp, vp, vp]
    lib.shine_blockmax_scan2.restype = i32
    lib.shine_blockmax_scan2.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp]
    lib.shine_classmax_scan_routed.restype = i32
    lib.shine_classmax_scan_routed.argtypes = [vp, i32, vp, vp, vp, i32, i32, i32, i32, i32,
                                               i32, i32, vp, vp, vp]
    return lib


def build_libs(checkouts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """The kernel library of each checkout, built at once, each by its own
    builder, bound."""
    procs = {k: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, path],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, path in checkouts.items()}
    libs = {}
    for k, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{k}: the build failed\n{err[-4000:]}")
        libs[k] = bind_entries(ctypes.CDLL(out.strip().splitlines()[-1]))
    return libs


def cuda_ms(fn, reps: int) -> float:
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


def routed_forms(dev, rng) -> list:
    """K4 at each routed route's own launch on routed-4m (chip_smoke.py's
    build and routes), on the index's int8 table and on it widened to bf16,
    with integer queries."""
    import chip_smoke as cs
    from shine_tpu_torch import build_routed_split
    from shine_tpu_torch.models import routed_split as rs

    ds = synthetic_dataset(n=cs.RN, dim=D, num_queries=cs.NQ, seed=cs.SEED,
                           compute_gt=False)
    index = build_routed_split(cs.RN, D, base_dev=torch.from_numpy(ds.base).to(dev),
                               **cs.ROUTED_BUILD)
    probes = rs._auto_probes(index.C)
    served = {}
    for route, knobs in cs.ROUTED_ROUTES:
        T, P = rs._auto_knobs(index.C, probes, knobs.get("tile", 0), knobs.get("shared", 0))
        served[route] = {"T": T, "P": P, "probes": probes}
    index.search(ds.queries, 10, batch_size=B, **dict(cs.ROUTED_ROUTES)["starved"])
    served["starved"]["spill"] = index.last_spill.copy()
    comp8, aux_r = index.comp, index.aux_r
    comp16 = comp8.to(torch.bfloat16)
    forms = []
    for route, T, q_s, cols in cs._k4_inputs(index, ds, served, dev):
        q = torch.from_numpy(rng.integers(-4, 5, size=q_s.shape).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        for dt, comp in (("int8", comp8), ("bf16", comp16)):
            forms.append((f"routed_classmax_scan {dt} {route} T={T} B={q.shape[0]} "
                          f"P={cols.shape[1]}",
                          lambda comp=comp, q=q, cols=cols, T=T: k4.routed_classmax_scan(
                              comp, aux_r, q, cols, T=T, cap=index.cap, cls=index.cls)))
    return forms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="the other checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda:0")
    libs = build_libs({"base": os.path.abspath(args.base), "this": REPO})
    ds = synthetic_dataset(n=N, dim=D, num_queries=B, seed=7, compute_gt=False)
    ext = pack_ext_table(ds.base, 0, -(-N // QUANTUM) * QUANTUM, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(ds.queries).to(dev), ext.shape[1]).to(
        torch.bfloat16)
    forms = [(f"classmax_scan keep{2 if k2 else 1}", lambda k2=k2: (
        cm.classmax2_scan if k2 else cm.classmax_scan)(ext, q_ext, cls=CLS))
        for k2 in (False, True)]
    forms.append(("blockmax_scan", lambda: bm.blockmax_scan(ext, q_ext)))
    rng = np.random.default_rng(7)
    ext_i = pack_ext_table(rng.integers(-3, 4, size=(N, D)).astype(np.float32), 0,
                           ext.shape[0], device=dev)
    q_i = pack_ext_query(torch.from_numpy(rng.integers(-3, 4, size=(B, D)).astype(
        np.float32)).to(dev), ext.shape[1]).to(torch.bfloat16)
    forms.append(("blockmax_scan2 (integer rows)", lambda: bm.blockmax_scan2(ext_i, q_i)))
    for dt in ("bf16", "int8"):
        comp, aux = pack_split_tables(ds.base, 0, -(-N // SPLIT_QUANTUM) * SPLIT_QUANTUM,
                                      comp_dtype=dt, device=dev)
        q = pack_split_query(torch.from_numpy(ds.queries).to(dev), comp.shape[1])
        forms += [(f"classmax_scan_split {dt} keep{2 if k2 else 1}",
                   lambda comp=comp, aux=aux, q=q, k2=k2: cm.classmax_scan_split(
                       comp, aux, q, cls=CLS, keep2=k2)) for k2 in (False, True)]
    forms += routed_forms(dev, rng)
    for name, run in forms:
        ms, outs = {"base": [], "this": []}, {}
        for side in ("base", "this", "this", "base"):
            _build._lib = libs[side]
            outs[side] = run()
            ms[side].append(cuda_ms(run, args.reps))
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(outs["base"], outs["this"]))
        print(json.dumps({"form": name, "base_ms": ms["base"], "this_ms": ms["this"],
                          "outputs_equal": same}), flush=True)
        if not same:
            raise AssertionError(f"{name}: the two libraries disagree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
