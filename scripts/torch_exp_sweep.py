#!/usr/bin/env python
"""Experiment sweep: the port of the JAX package's
``scripts/exp_sweep.py``.

The reference's exp_*.py scripts grid over datasets x labels x Zipf alpha x
threads/cache/CN count and push each run's JSON to MongoDB
(``exp_scalability.py``, ``benchmark.py:71-79``). Here each grid point is
one ``python -m shine_tpu_torch`` run (the mesh is in the process, stacked
on the card or on the CPU), and its Statistics document is appended to a
JSON-lines file that ``scripts/torch_collect_results.py`` turns into CSV.
The grid, its order, the children's flags and their labels are the JAX
script's; ``--device`` (cuda, the default, or cpu) goes to every child in
place of JAX's ``--cpu-mesh`` (a mesh of shards needs no virtual devices
here). On a card each document gains ``meta.card``, the card's name and
power limit.

A child that fails has its error's tail printed; the rest of the grid
runs, and the sweep then exits 1 (the JAX script exits 0).

    python scripts/torch_exp_sweep.py --out results.jsonl \\
        --synthetic 200000:128 --index hnsw flat ivf --ef-search 64 96 128
    python scripts/torch_exp_sweep.py --out skew.jsonl --synthetic 100000:64 \\
        --index hnsw --shards 8 --zipf 0 0.75 1.25 --cache-ratio 0 0.02 0.10
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from shine_tpu_torch.device import resolve_device  # noqa: E402
from shine_tpu_torch.utils.meter import card_line  # noqa: E402


@dataclasses.dataclass
class Config:
    synthetic: str = "100000:64"
    data_path: str | None = None
    index: tuple = ("hnsw",)
    ef_search: tuple = (128,)
    shards: tuple = (1,)
    zipf: tuple = (0.0,)
    cache_ratio: tuple = (-1.0,)
    num_queries: int = 2000
    index_cache: str | None = None
    label: str = "sweep"
    extra: tuple = ()


def child_argv(cfg: Config, dev: torch.device, index: str, ef: int, shards: int,
               zipf: float, ratio: float) -> list[str]:
    """One grid point's ``python -m shine_tpu_torch`` command, flags in the
    JAX script's order, then ``--device``; the label is
    ``{label}:{index}`` with ``:cache{ratio}`` or ``:nocache``."""
    label = f"{cfg.label}:{index}"
    cmd = [sys.executable, "-m", "shine_tpu_torch", "--index", index,
           "--ef-search", str(ef), "--shards", str(shards),
           "--zipf", str(zipf), "--num-queries", str(cfg.num_queries)]
    if ratio > 0:
        cmd += ["--cache", "--cache-ratio", str(ratio)]
        label += f":cache{ratio:g}"
    elif ratio == 0:
        label += ":nocache"
    cmd += ["--label", label]
    if cfg.data_path:
        cmd += ["--data-path", cfg.data_path]
    else:
        cmd += ["--synthetic", cfg.synthetic]
    if index == "hnsw" and cfg.index_cache:
        if os.path.exists(cfg.index_cache):
            cmd += ["--load-index", cfg.index_cache]
        else:
            cmd += ["--store-index", cfg.index_cache]
    return cmd + ["--device", dev.type, *cfg.extra]


def run(cfg: Config, dev: torch.device, out: str) -> tuple[list[dict], list[str]]:
    """Every grid point once, in the JAX script's order; each child's
    document appended to ``out``. Returns (the documents, the failed
    children's labels)."""
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    card = card_line(dev)
    grid = list(itertools.product(cfg.index, cfg.ef_search, cfg.shards, cfg.zipf,
                                  cfg.cache_ratio))
    docs, failed = [], []
    for i, point in enumerate(grid):
        cmd = child_argv(cfg, dev, *point)
        label = cmd[cmd.index("--label") + 1]
        print(f"[{i + 1}/{len(grid)}] {' '.join(cmd)}", file=sys.stderr, flush=True)
        res = subprocess.run(cmd, capture_output=True, text=True, env=env)
        try:
            doc = json.loads(res.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            doc = None
        if res.returncode != 0 or not isinstance(doc, dict):
            print(f"[{i + 1}/{len(grid)}] {label} failed (rc {res.returncode}):\n"
                  f"{res.stderr[-2000:]}", file=sys.stderr, flush=True)
            failed.append(label)
            continue
        if card is not None:
            doc["meta"]["card"] = card
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(doc) + "\n")
        docs.append(doc)
    if failed:
        print(f"# {len(failed)} of {len(grid)} runs failed: {failed}", file=sys.stderr)
    return docs, failed


def main(argv: list[str] | None = None) -> int:
    d = Config()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="JSONL results file (append)")
    p.add_argument("--device", default=None,
                   help="every child's --device: cuda (the default) or cpu")
    p.add_argument("--synthetic", default=d.synthetic)
    p.add_argument("--data-path")
    p.add_argument("--index", nargs="+", default=d.index)
    p.add_argument("--ef-search", nargs="+", type=int, default=d.ef_search)
    p.add_argument("--shards", nargs="+", type=int, default=d.shards)
    p.add_argument("--zipf", nargs="+", type=float, default=d.zipf)
    p.add_argument("--cache-ratio", nargs="+", type=float, default=d.cache_ratio,
                   help="cache sweep axis; 0 = cache off, -1 = axis unused "
                        "(exp_cache_size_and_skew.py analogue)")
    p.add_argument("--num-queries", type=int, default=d.num_queries)
    p.add_argument("--index-cache",
                   help="store the first hnsw run's graph here, load it in "
                        "the rest (benchmark.py:82-88 builds once too)")
    p.add_argument("--label", default=d.label)
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=d.extra)
    args = vars(p.parse_args(argv))
    out, dev = args.pop("out"), resolve_device(args.pop("device"))
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in args.items()})
    _, failed = run(cfg, dev, out)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
