"""Single-file checkpoints: the arrays of a ``GraphSoA``, or of a
``RoutedSplitIndex``, plus a JSON header, in one ``.npz``. The format is
that of ``shine_tpu/io/checkpoint.py`` (version 1), so that a file saved by
either package loads in the other."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

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


def save_routed_split(idx, path: str) -> None:
    """Write a RoutedSplitIndex's clustered split tables and centroids to
    one .npz in the JAX package's format (bf16 components as a uint16
    view, ``cap`` in the header). The base is not stored: give it again at
    load."""
    if idx.comp.dtype == torch.int8:
        comp, comp_tag = idx.comp.cpu().numpy(), "int8"
    else:
        comp, comp_tag = idx.comp.cpu().view(torch.int16).numpy().view(np.uint16), "bf16"
    header = {
        "version": _FORMAT_VERSION,
        "kind": "routed_split",
        "n": int(idx.n),
        "dim": int(idx.dim),
        "metric": int(idx.metric),
        "cls": int(idx.cls),
        "cap": int(idx.cap),
        "comp_dtype": comp_tag,
        "has_row_source": False,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            comp=comp,
            aux_r=idx.aux_r.cpu().numpy(),
            gid=idx.gid.cpu().numpy(),
            centroids=idx.centroids.cpu().numpy(),
        )
    os.replace(tmp, path)


def load_routed_split(path: str, *, base_dev: torch.Tensor | None = None,
                      device: torch.device | str | None = None):
    """Load a RoutedSplitIndex written by either package onto ``device``
    (the base's device when ``base_dev`` is given, else the CUDA card
    unless another is named). ``base_dev`` (n, d) is the resident base the
    re-rank reads. The components are cut to the port's width (the JAX
    package pads them to 128 lanes with zeros)."""
    from shine_tpu_torch.convert import _cut_to_width, _to_torch
    from shine_tpu_torch.device import resolve_device
    from shine_tpu_torch.models.routed_split import RoutedSplitIndex
    from shine_tpu_torch.ops.distance import squared_norms
    from shine_tpu_torch.ops.scan_split import comp_width

    dev = base_dev.device if base_dev is not None else resolve_device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {header['version']}")
        if header.get("kind") != "routed_split":
            raise ValueError("not a routed_split checkpoint")
        if header["has_row_source"]:
            raise NotImplementedError("row_source checkpoints (rows regenerated "
                                      "from a key) are not ported yet: ROADMAP A6")
        comp = _cut_to_width(z["comp"], comp_width(header["dim"]), "comp")
        comp = torch.from_numpy(comp.view(np.int16) if header["comp_dtype"] == "bf16"
                                else comp)
        if header["comp_dtype"] == "bf16":
            comp = comp.view(torch.bfloat16)
        arrays = {k: _to_torch(z[k]).to(dev) for k in ("aux_r", "gid", "centroids")}
    sqnorms = None
    if base_dev is not None:
        sqnorms = (squared_norms(base_dev) if header["metric"] == 0
                   else torch.zeros(header["n"], dtype=torch.float32, device=dev))
    return RoutedSplitIndex(
        arrays["centroids"], comp.to(dev), arrays["aux_r"], arrays["gid"],
        header["n"], header["dim"], header["metric"], cls=header["cls"],
        cap=header.get("cap"), base_dev=base_dev, sqnorms=sqnorms)
