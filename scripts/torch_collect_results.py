#!/usr/bin/env python
"""JSON-lines Statistics documents -> CSV: the port of the JAX package's
``scripts/collect_results.py`` (the reference's ``fetch_*.py``, which pull
MongoDB documents into CSVs keyed on meta labels).

It reads either package's document (``python -m shine_tpu`` or ``python -m
shine_tpu_torch``, one a line, as ``scripts/torch_exp_sweep.py`` appends
them) and writes the JAX collector's 14 columns, so that one JSON-lines file
gives the same CSV bytes through either script. ``meta.framework``,
``meta.device`` and ``meta.card`` are not columns.

    python scripts/torch_collect_results.py results/torch_skew_budget_1m.jsonl \\
        --out results/torch_skew_budget_1m.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

COLUMNS = [
    ("label", ("meta", "label")),
    ("dataset", ("meta", "dataset")),
    ("shards", ("meta", "num_shards")),
    ("zipf", ("meta", "zipf")),
    ("m", ("hnsw_parameters", "m")),
    ("ef_search", ("hnsw_parameters", "ef_search")),
    ("build_ms", ("build", "build_time_ms")),
    ("qps", ("queries", "queries_per_sec")),
    ("recall", ("queries", "recall")),
    ("distcomps", ("queries", "distance_computations")),
    ("scanned_rows", ("queries", "scanned_rows")),
    ("hbm_bytes", ("queries", "hbm_gather_bytes")),
    ("ici_bytes", ("queries", "ici_exchange_bytes")),
    ("cache_hit_rate", ("cache", "hit_rate")),
]


def _get(doc, path):
    """The value at ``path``, or "" where a key is missing."""
    for k in path:
        doc = doc.get(k, {}) if isinstance(doc, dict) else {}
    return doc if not isinstance(doc, dict) else ""


def rows(jsonl: str) -> list[list]:
    """One row of the columns a non-blank line of ``jsonl``."""
    with open(jsonl) as f:
        return [[_get(json.loads(line), path) for _, path in COLUMNS]
                for line in f if line.strip()]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("jsonl")
    p.add_argument("--out", default="-", help="the CSV file (- for stdout)")
    args = p.parse_args(argv)
    table = rows(args.jsonl)
    out = sys.stdout if args.out == "-" else open(args.out, "w", newline="")
    try:
        w = csv.writer(out)
        w.writerow([c for c, _ in COLUMNS])
        w.writerows(table)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
