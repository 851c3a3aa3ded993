"""Ablate the fused beam step of csrc/gather_score.cu on one CUDA card: what
its row scoring, its merge and its other phases cost, and what more loads
in flight or more resident CTAs change.

    python scripts/torch_beam_step_ablate.py [--reps 20] [--variants a,b,...]

Each variant is this checkout's ``csrc/gather_score.cu`` with an edit,
compiled alone by nvcc (the flags of ``shine_tpu_torch.ops._build``) into
``build/ablate_k1/``, all at once. Variants:

    this               the kernel as it is
    no_score           the kept rows not read: each scores as its id
    no_merge           the merge skipped (the pads still written)
    no_score_no_merge  both
    no_lists           the lists not read: no lane, no row, no merge
    gate_only          the CTA returns once the beam and query are loaded
    unroll8            eight row groups in flight a warp instead of four
    occ6               beam_step's registers capped for 6 resident CTAs

The step is scripts/torch_k1_ab.py's (step 8 of a batch of 4096 queries over
the 1,000,000 x 128 set's rows, random lists of width 32, ef=96, frontier=8),
its state made by this checkout's kernel and restored before every run;
f32, bf16 and int8 rows. Prints one JSON line a row type (the median of
``--reps`` CUDA-event timings of each variant, in the order given and then
reversed), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from shine_tpu_torch.ops import _build  # noqa: E402
from torch_k1_ab import (  # noqa: E402
    SEARCH,
    STEP,
    W,
    bind,
    make_inputs,
    step_state,
    time_step,
)

SRC = os.path.join(REPO, "shine_tpu_torch", "csrc", "gather_score.cu")
OUT = os.path.join(REPO, "build", "ablate_k1")


def _nth(s: str, old: str, new: str, n: int) -> str:
    """``s`` with the n-th occurrence (0-based) of ``old`` replaced."""
    at = -1
    for _ in range(n + 1):
        at = s.index(old, at + 1)
    return s[:at] + new + s[at + len(old):]


NO_SCORE = ("      sc.score(rid, dist);\n",
            "#pragma unroll\n      for (int u = 0; u < kUnroll; ++u) dist[u] = float(rid[u]);\n",
            0)  # beam_step's call (gather_score_kernel's is indented less)
NO_MERGE = ("  for (int x = tid; x < n_all; x += kThreads) {",
            "  for (int x = tid; x < 0; x += kThreads) {", 0)
EDITS = {
    "this": [],
    "no_score": [NO_SCORE],
    "no_merge": [NO_MERGE],
    "no_score_no_merge": [NO_SCORE, NO_MERGE],
    "no_lists": [("f < n_act ? __ldg(", "false ? __ldg(", 0)],
    "gate_only": [("  if (tid == 0) s_valid = s_kept = s_beam = s_surv = s_unsettled = 0;\n"
                   "  __syncthreads();\n",
                   "  if (tid == 0) s_valid = s_kept = s_beam = s_surv = s_unsettled = 0;\n"
                   "  __syncthreads();\n  if (n_rows >= 0) return;\n", 0)],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;", 0)],
    "occ6": [("__global__ void __launch_bounds__(kThreads)\nbeam_step_kernel",
              "__global__ void __launch_bounds__(kThreads, 6)\nbeam_step_kernel", 0)],
}


def build(variants: list[str]) -> dict:
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    procs = {}
    for v in variants:
        text = src
        for old, new, n in EDITS[v]:
            text = _nth(text, old, new, n)
        cu = os.path.join(OUT, f"{v}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"{v}.so")
        procs[v] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"variant {v} did not build:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(json.dumps({"variant": v, "ptxas": regs[-6:]}), flush=True)
        libs[v] = bind(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default=",".join(EDITS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_beam_step_ablate.py needs a CUDA card")
    variants = args.variants.split(",")
    libs = build(variants)
    inp = make_inputs()
    for rows in ("f32", "bf16", "int8"):
        tables, state, snap = step_state(inp, rows)
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            times[v].append(time_step(libs[v], inp, tables, state, snap, args.reps))
        print(json.dumps({"rows": rows, "step": STEP, "ef": SEARCH.ef,
                          "frontier": SEARCH.frontier, "W": W, "ms": times}),
              flush=True)
        del tables, state, snap
        torch.cuda.empty_cache()
    shutil.rmtree(OUT, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
