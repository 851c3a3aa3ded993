"""Checkpoints: the arrays of a ``GraphSoA``, or of a ``RoutedSplitIndex``,
plus a JSON header, in one ``.npz``; or a graph in one ``.npz`` a shard
(``save_graph_sharded``, as the reference writes one dump a memory node).
The format is that of ``shine_tpu/io/checkpoint.py`` (version 1), so that a
file or directory saved by either package loads in the other."""

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


def save_graph_sharded(graph: GraphSoA, directory: str, num_shards: int) -> None:
    """One file a shard, ``shard_{s}_of_{S}.npz`` (the reference's per-node
    dumps, compute_node.cc:428-430). Shard s holds rows [s * rows, (s + 1) *
    rows), the layout of ``parallel/sharded.py``; the upper-level lists ride
    with shard 0 (they are replicated on load anyway)."""
    os.makedirs(directory, exist_ok=True)
    n = graph.n
    rows = -(-n // num_shards)
    header = {
        "version": _FORMAT_VERSION,
        "M": graph.params.M,
        "ef_construction": graph.params.ef_construction,
        "metric": graph.params.metric,
        "seed": graph.params.seed,
        "entry_point": int(graph.entry_point),
        "top_level": int(graph.top_level),
        "num_shards": num_shards,
        "rows_per_shard": rows,
        "n": n,
    }
    for s in range(num_shards):
        lo, hi = s * rows, min((s + 1) * rows, n)
        payload = {
            "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            "vectors": graph.vectors[lo:hi],
            "levels": graph.levels[lo:hi],
            "neighbors0": graph.neighbors0[lo:hi],
            "upper_row": graph.upper_row[lo:hi],
        }
        if s == 0:
            payload["upper_neighbors"] = graph.upper_neighbors
        path = os.path.join(directory, f"shard_{s}_of_{num_shards}.npz")
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **payload)
        os.replace(path + ".tmp", path)


def load_graph_sharded(directory: str) -> GraphSoA:
    """The whole graph from a directory of ``save_graph_sharded``."""
    with np.load(os.path.join(directory, _find_shard0(directory))) as first:
        header = json.loads(bytes(first["header"]).decode())
    if header["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {header['version']}")
    S = header["num_shards"]
    parts = {"vectors": [], "levels": [], "neighbors0": [], "upper_row": []}
    upper = None
    for s in range(S):
        with np.load(os.path.join(directory, f"shard_{s}_of_{S}.npz")) as z:
            for k in parts:
                parts[k].append(z[k])
            if s == 0:
                upper = z["upper_neighbors"]
    params = HNSWParams(
        M=header["M"],
        ef_construction=header["ef_construction"],
        metric=header["metric"],
        seed=header["seed"],
    )
    return GraphSoA(
        params=params,
        vectors=np.concatenate(parts["vectors"]),
        levels=np.concatenate(parts["levels"]),
        neighbors0=np.concatenate(parts["neighbors0"]),
        upper_row=np.concatenate(parts["upper_row"]),
        upper_neighbors=upper,
        entry_point=header["entry_point"],
        top_level=header["top_level"],
    )


def _find_shard0(directory: str) -> str:
    for f in sorted(os.listdir(directory)):
        if f.startswith("shard_0_of_") and f.endswith(".npz"):
            return f
    raise FileNotFoundError(f"no shard_0_of_*.npz under {directory}")


def index_path(root: str, name: str, params: HNSWParams, num_shards: int = 1) -> str:
    """The file name that encodes the build parameters, after the
    reference's ``index_m{M}_efc{EFC}_node{i}_of{n}.dat``
    (compute_node.cc:428-430)."""
    return os.path.join(
        root,
        f"{name}_m{params.M}_efc{params.ef_construction}_{params.metric}"
        f"_s{num_shards}.npz",
    )


def save_routed_split(idx, path: str) -> None:
    """Write a RoutedSplitIndex's clustered split tables and centroids to
    one .npz in the JAX package's format (bf16 components as a uint16
    view, ``cap`` in the header). A row source rides along (``rs_key``
    uint32[2], ``rs_centers`` f32), so the exact regen re-rank survives the
    round trip; a resident base is not stored: give it again at load."""
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
        "has_row_source": idx.row_source is not None,
    }
    arrays = {}
    if idx.row_source is not None:
        key, centers = idx.row_source
        arrays["rs_key"] = np.asarray(torch.as_tensor(key).cpu().numpy(), np.uint32)
        arrays["rs_centers"] = centers.cpu().numpy().astype(np.float32)
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
            **arrays,
        )
    os.replace(tmp, path)


def load_routed_split(path: str, *, base_dev: torch.Tensor | None = None,
                      device: torch.device | str | None = None):
    """Load a RoutedSplitIndex written by either package onto ``device``
    (the base's device when ``base_dev`` is given, else the CUDA card
    unless another is named), with its row source when the file carries
    one (the key as an int64 tensor (2,) on the CPU, the centres on the
    device). ``base_dev`` (n, d) is a resident base for the re-rank. The
    components are cut to the port's width (the JAX package pads them to
    128 lanes with zeros)."""
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
        row_source = None
        if header["has_row_source"]:
            row_source = (torch.from_numpy(z["rs_key"].astype(np.int64)),
                          _to_torch(z["rs_centers"].astype(np.float32)).to(dev))
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
        cap=header.get("cap"), row_source=row_source, base_dev=base_dev,
        sqnorms=sqnorms)
