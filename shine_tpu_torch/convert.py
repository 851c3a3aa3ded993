"""Carry the JAX package's index state over to the port.

The JAX ``DeviceGraph`` (graph lists and stored rows) and the JAX
``FastFlatIndex`` (packed table, rows, norms, permutation) are this
system's state. ``device_graph_from_jax`` and ``fastflat_from_jax`` take
their fields as numpy arrays, so that both packages serve one index, and
import nothing of JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.models.flat import FastFlatIndex
from shine_tpu_torch.models.hnsw import DeviceGraph
from shine_tpu_torch.ops.scan import ext_width

_TABLES = ("vectors_ext", "neighbors0", "upper_row", "upper_neighbors",
           "upper_ids", "upper_vecs_ext", "row_scl", "row_nrm")


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # jax arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def unpack_neighbors(packed: np.ndarray, nbr_width: int, n: int) -> np.ndarray:
    """Undo ``shine_tpu.models.hnsw._pack_neighbors``: (ceil(n/p), p*W)
    rows holding p lists each -> (n, W)."""
    width = packed.shape[1]
    if nbr_width <= 0 or width % nbr_width:
        raise ValueError(
            f"nbr_width={nbr_width} does not divide the list table's width "
            f"{width}"
        )
    flat = packed.reshape(-1, nbr_width)
    if flat.shape[0] < n:
        raise ValueError(f"list table holds {flat.shape[0]} lists, need {n}")
    return flat[:n]


def device_graph_from_jax(
    arrays: Mapping[str, np.ndarray | None],
    *,
    top_level: int,
    nbr_width: int,
    device: torch.device | str | None = None,
) -> DeviceGraph:
    """The port's DeviceGraph from the JAX DeviceGraph's fields as numpy
    arrays (``{k: np.asarray(v) for k, v in g._asdict().items()}``), on
    ``device`` (the CUDA card unless another is given). ``nbr_width`` is
    the true layer-0 list width (2M); a packed ``neighbors0`` is unpacked
    with it."""
    device = resolve_device(device)
    n = arrays["vectors_ext"].shape[0]
    fields = dict(arrays)
    fields["neighbors0"] = unpack_neighbors(
        np.asarray(fields["neighbors0"]), nbr_width, n)
    tables = {
        k: _to_torch(np.asarray(fields[k])).to(device)
        for k in _TABLES if fields.get(k) is not None
    }
    return DeviceGraph(
        entry_point=int(np.asarray(arrays["entry_point"])),
        top_level=int(top_level),
        **tables,
    )


def fastflat_from_jax(
    arrays: Mapping[str, np.ndarray | None],
    *,
    n: int,
    dim: int,
    metric: str | int,
    device: torch.device | str | None = None,
) -> FastFlatIndex:
    """The port's FastFlatIndex holding the JAX FastFlatIndex's state, on
    ``device`` (the CUDA card unless another is given): ``ext`` (ml_dtypes
    bf16, carried as raw bits), ``vectors``, ``sqnorms`` and ``perm``, as
    numpy (``vectors`` and ``sqnorms`` None for a table-only index). The
    table is cut to the port's width; the columns dropped are the JAX
    package's zero lane padding. Both packages then answer the same
    queries from the same state."""
    device = resolve_device(device)
    ext = np.asarray(arrays["ext"])
    width = ext_width(dim)
    if ext.shape[1] < width or np.any(ext[:, width:].view(np.int16)):
        raise ValueError(
            f"ext is {ext.shape[1]} wide; columns past {width} must be zero")
    self = FastFlatIndex.from_ext(
        _to_torch(np.ascontiguousarray(ext[:, :width])).to(device), n, metric,
        dim=dim)
    if arrays.get("vectors") is not None:
        self.vectors = _to_torch(np.asarray(arrays["vectors"])).to(device)
        self.sqnorms = _to_torch(np.asarray(arrays["sqnorms"])).to(device)
    if arrays.get("perm") is not None:
        self.perm = np.asarray(arrays["perm"]).astype(np.int32)
    return self
