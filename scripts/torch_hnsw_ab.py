"""Serve the hnsw-1m-sift-shape cell with two checkouts of the PyTorch port
on one CUDA card, in turns, and compare recall@10 and QPS.

    python scripts/torch_hnsw_ab.py --base DIR [--threads 8] [--passes 3]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``). The script generates chip_smoke.py's set
(1,000,000 x 128, 10,000 queries, L2, seed 7), builds the native graph
(M=16, ef_construction=200) with this checkout's builder while both
checkouts build their kernel libraries, computes exact fp32 ground truth on
the card, and saves the graph, the queries and the ground truth under
build/hnsw_ab/. Each checkout then serves the set from those files in a
process of its own, in the order base, this, this, base: f32 rows, then
bf16 rows, at k=10, ef=96, frontier=8 and batch 4096, a warm-up pass and
``--passes`` timed passes (host wall time, CUDA-synchronised). Prints one
JSON line a pass, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shine_tpu_torch.config import HNSWParams  # noqa: E402
from shine_tpu_torch.graph.soa import build_graph  # noqa: E402
from shine_tpu_torch.io import save_graph, synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops.distance import exact_knn  # noqa: E402

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")
_SERVE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.config import SearchParams
from shine_tpu_torch.io import load_graph, recall_at_k
data, label, passes = sys.argv[2], sys.argv[3], int(sys.argv[4])
graph = load_graph(f"{data}/graph.npz")
queries, gt = np.load(f"{data}/queries.npy"), np.load(f"{data}/gt.npy")
sp = SearchParams(k=10, ef=96, frontier=8)
for rows in ("f32", "bf16"):
    index = HNSWIndex(graph, rows=rows, device="cuda")
    index.search(queries, sp, batch_size=4096)
    torch.cuda.synchronize()
    for p in range(passes):
        t0 = time.perf_counter()
        ids, _ = index.search(queries, sp, batch_size=4096)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"checkout": label, "rows": rows, "pass": p,
                          "recall@10": recall_at_k(ids, gt, 10),
                          "qps": len(queries) / wall, "wall_s": wall,
                          "beam_steps": index.last_steps,
                          "mean_hops": index.last_hops / len(queries)}),
              flush=True)
    del index
    torch.cuda.empty_cache()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--threads", type=int, default=min(os.cpu_count() or 1, 32))
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_hnsw_ab.py needs a CUDA card")
    checkouts = {"base": os.path.abspath(args.base), "this": REPO}
    builds = {k: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, path])
              for k, path in checkouts.items()}

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    graph = build_graph(ds.base, HNSWParams(M=16, ef_construction=200),
                        threads=args.threads)
    print(f"# native build on {args.threads} threads: "
          f"{time.perf_counter() - t0:.2f} s with the data", flush=True)
    gt, _ = exact_knn(torch.from_numpy(ds.base).cuda(),
                      torch.from_numpy(ds.queries).cuda(), 10)
    data = os.path.join(REPO, "build", "hnsw_ab")
    os.makedirs(data, exist_ok=True)
    save_graph(graph, os.path.join(data, "graph.npz"))
    np.save(os.path.join(data, "queries.npy"), ds.queries)
    np.save(os.path.join(data, "gt.npy"), gt.cpu().numpy())
    del ds, graph, gt
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
