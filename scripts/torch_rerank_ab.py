"""Serve the 1M cells whose exact re-rank runs through ``rerank_topk`` with
two checkouts of the PyTorch port on one CUDA card, in turns, and compare
recall@10, QPS and K1's launches.

    python scripts/torch_rerank_ab.py --base DIR [--passes 3]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``). The script generates chip_smoke.py's set
(1,000,000 x 128, 10,000 queries, L2, seed 7), computes exact fp32 ground
truth on the card and saves the base, the queries and the ground truth
under build/rerank_ab/, while both checkouts build their kernel libraries.
Each checkout then serves the set in a process of its own, in the order
base, this, this, base, at batch 4096 and the auto knobs: FastFlatIndex,
SplitFlatIndex with bf16 and with int8 components, build_routed_split over
the resident base (cap 4096, cls 1024, int8, seed 1234, as chip_smoke.py's
routed cell) and IVFIndex (seed 1234) at probes 32. Each route gets a
warm-up pass and ``--passes`` timed passes (host wall time,
CUDA-synchronised). Prints one JSON line a pass with the pass's
``gather_score`` launches, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops.distance import exact_knn  # noqa: E402

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")
_SERVE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.models.flat import FastFlatIndex, SplitFlatIndex
from shine_tpu_torch.models.ivf import IVFIndex
from shine_tpu_torch.models.routed_split import build_routed_split
from shine_tpu_torch.ops.gather_score import gather_score
data, label, passes = sys.argv[2], sys.argv[3], int(sys.argv[4])
base = np.load(f"{data}/base.npy")
queries, gt = np.load(f"{data}/queries.npy"), np.load(f"{data}/gt.npy")
B = 4096


def routes():
    yield "fastflat", lambda: FastFlatIndex(base, device="cuda"), {}
    yield "split_bf16", lambda: SplitFlatIndex(base, comp_dtype="bf16", device="cuda"), {}
    yield "split_int8", lambda: SplitFlatIndex(base, comp_dtype="int8", device="cuda"), {}
    yield "routed", lambda: build_routed_split(
        base.shape[0], base.shape[1], base_dev=torch.from_numpy(base).cuda(),
        cap_target=4096, cls=1024, comp_dtype="int8", cap_slack=1.05, assign_r=8,
        seed=1234), {}
    yield "ivf_p32", lambda: IVFIndex(base, seed=1234, device="cuda"), {"probes": 32}


for name, make, knobs in routes():
    index = make()
    index.search(queries, 10, batch_size=B, **knobs)
    torch.cuda.synchronize()
    for p in range(passes):
        gather_score.launches = 0
        t0 = time.perf_counter()
        ids, _ = index.search(queries, 10, batch_size=B, **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"checkout": label, "route": name, "pass": p,
                          "recall@10": recall_at_k(ids, gt, 10),
                          "qps": len(queries) / wall, "wall_s": wall,
                          "gather_score_launches": gather_score.launches}),
              flush=True)
    del index
    torch.cuda.empty_cache()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rerank_ab.py needs a CUDA card")
    checkouts = {"base": os.path.abspath(args.base), "this": REPO}
    builds = {k: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, path])
              for k, path in checkouts.items()}

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    gt, _ = exact_knn(torch.from_numpy(ds.base).cuda(),
                      torch.from_numpy(ds.queries).cuda(), 10)
    data = os.path.join(REPO, "build", "rerank_ab")
    os.makedirs(data, exist_ok=True)
    np.save(os.path.join(data, "base.npy"), ds.base)
    np.save(os.path.join(data, "queries.npy"), ds.queries)
    np.save(os.path.join(data, "gt.npy"), gt.cpu().numpy())
    print(f"# the set and its ground truth: {time.perf_counter() - t0:.2f} s", flush=True)
    del ds, gt
    torch.cuda.empty_cache()
    for k, p in builds.items():
        if p.wait() != 0:
            raise SystemExit(f"the {k} checkout's kernels did not build")

    for label in ("base", "this", "this", "base"):
        rc = subprocess.call([sys.executable, "-c", _SERVE, checkouts[label],
                              data, label, str(args.passes)])
        if rc != 0:
            raise SystemExit(f"the {label} checkout's pass failed ({rc})")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
