"""Build the fastbuild-1m-sift-shape cell with two checkouts of the PyTorch
port on one CUDA card, in turns, and compare build seconds, recall@10 and
the graphs themselves.

    python scripts/torch_fastbuild_ab.py --base DIR

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``). The script generates chip_smoke.py's set
(1,000,000 x 128, 10,000 queries, L2, seed 7) while both checkouts build
their kernel libraries and native builders, computes exact fp32 ground
truth on the card, and saves the rows, the queries and the ground truth
under build/fastbuild_ab/. Each checkout then runs, in a process of its
own and in the order base, this, this, base, a warm-up build of 8,192 rows
and then ``fast_build_graph`` at chip_smoke.py's three settings (M=16,
ef_construction=200; pool 0, pool 200, the block-max sweep), the rows
resident on the card; each graph is served at k=10, ef=96, frontier=8,
f32 rows, batch 4096. Prints one JSON line a build (wall seconds,
CUDA-synchronised; recall@10; a SHA-256 of the levels, lists and entry
point), then whether each setting built the same graph in both checkouts,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops.distance import exact_knn  # noqa: E402

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch import native; from shine_tpu_torch.ops import _build; "
              "_build.load(); native.load(); print(_build.lib_path())")
_RUN = """
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from shine_tpu_torch import HNSWIndex, fast_build_graph
from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.io import recall_at_k
data, label = sys.argv[2], sys.argv[3]
base = np.load(f"{data}/base.npy")
queries, gt = np.load(f"{data}/queries.npy"), np.load(f"{data}/gt.npy")
params = HNSWParams(M=16, ef_construction=200)
base_t = torch.from_numpy(base).cuda()
fast_build_graph(base[:8192], params, base_dev=base_t[:8192])
for name, kw in (("pool0", {}), ("pool200", {"pool": 200}),
                 ("blockmax", {"blockmax": True})):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = fast_build_graph(base, params, base_dev=base_t, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = hashlib.sha256()
    for a in (graph.levels, graph.neighbors0, graph.upper_row, graph.upper_neighbors,
              np.array([graph.entry_point, graph.top_level])):
        digest.update(np.ascontiguousarray(a).tobytes())
    ids, _ = HNSWIndex(graph, rows="f32", device="cuda").search(
        queries, SearchParams(k=10, ef=96, frontier=8), batch_size=4096)
    print(json.dumps({"checkout": label, "build": name, "seconds": wall,
                      "recall@10": recall_at_k(ids, gt, 10),
                      "graph_sha256": digest.hexdigest()}), flush=True)
    del graph
    torch.cuda.empty_cache()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fastbuild_ab.py needs a CUDA card")
    checkouts = {"base": os.path.abspath(args.base), "this": REPO}
    builds = {k: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, path])
              for k, path in checkouts.items()}

    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    gt, _ = exact_knn(torch.from_numpy(ds.base).cuda(),
                      torch.from_numpy(ds.queries).cuda(), 10)
    data = os.path.join(REPO, "build", "fastbuild_ab")
    os.makedirs(data, exist_ok=True)
    np.save(os.path.join(data, "base.npy"), ds.base)
    np.save(os.path.join(data, "queries.npy"), ds.queries)
    np.save(os.path.join(data, "gt.npy"), gt.cpu().numpy())
    del ds, gt
    torch.cuda.empty_cache()
    for k, p in builds.items():
        if p.wait() != 0:
            raise SystemExit(f"the {k} checkout's kernels did not build")

    digests: dict[str, set] = {}
    for label in ("base", "this", "this", "base"):
        out = subprocess.run([sys.executable, "-c", _RUN, checkouts[label], data, label],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            raise SystemExit(f"the {label} checkout's builds failed ({out.returncode})")
        for line in out.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rec = json.loads(line)
                digests.setdefault(rec["build"], set()).add(rec["graph_sha256"])
    print(json.dumps({"same_graph": {b: len(d) == 1 for b, d in digests.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
