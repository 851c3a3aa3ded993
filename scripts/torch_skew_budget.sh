#!/bin/bash
# The graph family's cache-BUDGET x skew grid: the port of the JAX package's
# scripts/run_skew_budget_cpu.sh, the reference's headline experiment
# (exp_cache_size_and_skew.py:8-13: the 2-25% cache-size axis) on the sharded
# HNSW's hot-vertex replica, 8 shards stacked on one card.
#
# For each shape N:D (the JAX record's 131072:64 and the sift shape
# 1000000:128): the set (synthetic_dataset, seed 42 and 2,048 queries, as
# `python -m shine_tpu_torch --synthetic N:D --num-queries 2048` makes it)
# is written once with its exact top-10 from the card, so that no child
# recomputes the truth on the host; then scripts/torch_exp_sweep.py runs the
# JAX grid on it (hnsw, ef 64, --shards 8, Zipf 0/0.75/1.25 x cache ratio
# 0/0.02/0.05/0.10/0.15/0.25, the first child fast-builds the graph at the
# CLI's M=32, efc=500 and stores it, the rest load it), and
# scripts/torch_collect_results.py writes the CSV:
#   $OUT/torch_skew_budget_{131k,1m}.{jsonl,csv}, the log $OUT/torch_skew_budget.log
#
#   scripts/torch_skew_budget.sh [--device cpu] [N:D ...]
#   scripts/torch_skew_budget.sh                       # on the card, ~15 min
#   SHINE_SKB_OUT=build/skb scripts/torch_skew_budget.sh --device cpu 4096:16
#
# The shapes default to "131072:64 1000000:128"; SHINE_SKB_OUT (results) is
# where the records go. The sets and graphs are kept under .bench_cache.
set -u
cd "$(dirname "$0")/.."
DEVICE=cuda
if [ "${1:-}" = "--device" ]; then DEVICE=$2; shift 2; fi
SHAPES=${*:-"131072:64 1000000:128"}
OUT=${SHINE_SKB_OUT:-results}
CACHE=.bench_cache
mkdir -p "$OUT" "$CACHE"
exec > >(tee -a "$OUT/torch_skew_budget.log") 2>&1
rc=0
for shape in $SHAPES; do
  n=${shape%:*}
  d=${shape#*:}
  if [ $((n % 1000000)) -eq 0 ]; then tag=$((n / 1000000))m; else tag=$((n / 1000))k; fi
  set_dir=$CACHE/synth-${n}x${d}
  echo "[skewb] $(date) $shape start"
  python - "$n" "$d" "$set_dir" "$DEVICE" <<'EOF' || { echo "[skewb] $shape set rc=$?"; rc=1; continue; }
import sys
import torch
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.io import save_dataset, synthetic_dataset
from shine_tpu_torch.ops.distance import exact_knn
n, d, path, dev = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], resolve_device(sys.argv[4])
ds = synthetic_dataset(n=n, dim=d, num_queries=2048, seed=42, compute_gt=False)
gt, _ = exact_knn(torch.from_numpy(ds.base).to(dev), torch.from_numpy(ds.queries).to(dev), 10)
ds.ground_truth = gt.cpu().numpy()
save_dataset(ds, path)
print(f"[skewb] {n} x {d}, 2048 queries and their exact top-10 -> {path}")
EOF
  rm -f "$OUT/torch_skew_budget_$tag.jsonl" "$CACHE/torch_skewb_hnsw_${n}x${d}.npz"
  python scripts/torch_exp_sweep.py --out "$OUT/torch_skew_budget_$tag.jsonl" \
    --label skew_budget --data-path "$set_dir" --index hnsw \
    --shards 8 --device "$DEVICE" --ef-search 64 --num-queries 2048 \
    --zipf 0 0.75 1.25 --cache-ratio 0 0.02 0.05 0.10 0.15 0.25 \
    --index-cache "$CACHE/torch_skewb_hnsw_${n}x${d}.npz" \
    --extra --fast-build \
    || { echo "[skewb] $shape sweep rc=$?"; rc=1; }
  python scripts/torch_collect_results.py "$OUT/torch_skew_budget_$tag.jsonl" \
    --out "$OUT/torch_skew_budget_$tag.csv" || { echo "[skewb] $shape collect rc=$?"; rc=1; }
  echo "[skewb] $(date) $shape done"
done
exit $rc
