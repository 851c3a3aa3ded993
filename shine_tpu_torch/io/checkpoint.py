"""Single-file graph checkpoints: the arrays of a ``GraphSoA`` plus a JSON
header, in one ``.npz``. The format is that of
``shine_tpu/io/checkpoint.py`` (version 1), so that a graph saved by either
package loads in the other."""

from __future__ import annotations

import json
import os

import numpy as np

from shine_tpu_torch.config import HNSWParams
from shine_tpu_torch.graph.soa import GraphSoA

_FORMAT_VERSION = 1


def save_graph(graph: GraphSoA, path: str) -> None:
    """Write the whole graph to one .npz file (atomically, by rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = {
        "version": _FORMAT_VERSION,
        "M": graph.params.M,
        "ef_construction": graph.params.ef_construction,
        "metric": graph.params.metric,
        "seed": graph.params.seed,
        "entry_point": int(graph.entry_point),
        "top_level": int(graph.top_level),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            vectors=graph.vectors,
            levels=graph.levels,
            neighbors0=graph.neighbors0,
            upper_row=graph.upper_row,
            upper_neighbors=graph.upper_neighbors,
        )
    os.replace(tmp, path)


def load_graph(path: str) -> GraphSoA:
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {header['version']}")
        params = HNSWParams(
            M=header["M"],
            ef_construction=header["ef_construction"],
            metric=header["metric"],
            seed=header["seed"],
        )
        return GraphSoA(
            params=params,
            vectors=z["vectors"],
            levels=z["levels"],
            neighbors0=z["neighbors0"],
            upper_row=z["upper_row"],
            upper_neighbors=z["upper_neighbors"],
            entry_point=header["entry_point"],
            top_level=header["top_level"],
        )
