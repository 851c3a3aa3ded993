"""Carry the JAX package's index state over to the port.

The JAX ``DeviceGraph`` (graph lists and stored rows), the JAX
``BuildState`` (an insert build's tables and scalars), the JAX
``FastFlatIndex`` (packed table, rows, norms, permutation), the JAX
``SplitFlatIndex`` (component table, aux, rows, norms, permutation), the
JAX ``RoutedSplitIndex`` (centroids, clustered tables, row ids, base) and
the JAX ``IVFData`` (centroids, cluster blocks, their norms and ids, rows,
norms) are this system's state. ``device_graph_from_jax``,
``build_state_from_jax``, ``fastflat_from_jax``, ``splitflat_from_jax``,
``routed_split_from_jax`` and ``ivf_from_jax`` take their fields as
numpy arrays, so that both packages serve one index, and import nothing of
JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.models.build import BuildState
from shine_tpu_torch.models.flat import FastFlatIndex, SplitFlatIndex
from shine_tpu_torch.models.hnsw import DeviceGraph, check_lists
from shine_tpu_torch.models.ivf import IVFData, IVFIndex
from shine_tpu_torch.models.routed_split import RoutedSplitIndex
from shine_tpu_torch.ops.distance import squared_norms
from shine_tpu_torch.ops.scan import ext_width
from shine_tpu_torch.ops.scan_split import comp_width

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
    check_lists(fields["neighbors0"], n)
    tables = {
        k: _to_torch(np.asarray(fields[k])).to(device)
        for k in _TABLES if fields.get(k) is not None
    }
    return DeviceGraph(
        entry_point=int(np.asarray(arrays["entry_point"])),
        top_level=int(top_level),
        **tables,
    )


def build_state_from_jax(
    arrays: Mapping[str, np.ndarray],
    *,
    device: torch.device | str | None = None,
) -> BuildState:
    """The port's BuildState from the JAX BuildState's fields as numpy arrays
    (``{k: np.asarray(v) for k, v in st._asdict().items()}``), on ``device``
    (the CUDA card unless another is given): the tables gain the port's
    spare row (-1 lists, degree 0), the scalars become host ints. Both
    packages then run the next round from the same state."""
    device = resolve_device(device)

    def put(name: str, spare: int | None = None) -> torch.Tensor:
        a = np.asarray(arrays[name])
        if spare is not None:
            a = np.concatenate([a, np.full((1,) + a.shape[1:], spare, a.dtype)])
        return _to_torch(a).to(device)

    return BuildState(
        vectors=put("vectors"),
        vec_sqnorms=put("vec_sqnorms"),
        levels=put("levels"),
        upper_row=put("upper_row"),
        neighbors0=put("neighbors0", -1),
        degree0=put("degree0", 0),
        upper_neighbors=put("upper_neighbors", -1),
        upper_degree=put("upper_degree", 0),
        entry_point=int(arrays["entry_point"]),
        entry_level=int(arrays["entry_level"]),
        count=int(arrays["count"]),
    )


def _cut_to_width(table: np.ndarray, width: int, name: str) -> np.ndarray:
    """The first ``width`` columns of ``table``; the JAX package pads to
    128 lanes, and the columns dropped must be that zero padding."""
    if table.shape[1] < width or np.any(table[:, width:].view(np.int8)):
        raise ValueError(
            f"{name} is {table.shape[1]} wide; columns past {width} must be zero")
    return np.ascontiguousarray(table[:, :width])


def _attach_rows(index, arrays: Mapping[str, np.ndarray | None],
                 device: torch.device) -> None:
    if arrays.get("vectors") is not None:
        index.vectors = _to_torch(np.asarray(arrays["vectors"])).to(device)
        index.sqnorms = _to_torch(np.asarray(arrays["sqnorms"])).to(device)
    if arrays.get("perm") is not None:
        index.perm = np.asarray(arrays["perm"]).astype(np.int32)


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
    numpy (``vectors`` and ``sqnorms`` None for a table-only index), and
    the JAX index's ``interpret`` flag, which becomes the port's
    ``blockmax`` route (the one that flag picks in the JAX package). The
    table is cut to the port's width; the columns dropped are the JAX
    package's zero lane padding. Both packages then answer the same
    queries from the same state."""
    device = resolve_device(device)
    ext = _cut_to_width(np.asarray(arrays["ext"]), ext_width(dim), "ext")
    self = FastFlatIndex.from_ext(_to_torch(ext).to(device), n, metric, dim=dim,
                                  blockmax=bool(arrays.get("interpret", False)))
    _attach_rows(self, arrays, device)
    return self


def splitflat_from_jax(
    arrays: Mapping[str, np.ndarray | None],
    *,
    n: int,
    dim: int,
    metric: str | int,
    device: torch.device | str | None = None,
) -> SplitFlatIndex:
    """The port's SplitFlatIndex holding the JAX SplitFlatIndex's state, on
    ``device`` (the CUDA card unless another is given): ``comp`` (ml_dtypes
    bf16, carried as raw bits, or int8), ``aux``, ``vectors``, ``sqnorms``
    and ``perm``, as numpy (``vectors`` and ``sqnorms`` None for a
    table-only index, ``perm`` None for an unshuffled one). ``comp`` is
    cut to the port's width; the columns dropped are the JAX package's
    zero lane padding."""
    device = resolve_device(device)
    comp = _cut_to_width(np.asarray(arrays["comp"]), comp_width(dim), "comp")
    self = SplitFlatIndex.from_parts(
        _to_torch(comp).to(device),
        _to_torch(np.asarray(arrays["aux"], np.float32)).to(device), n, metric,
        dim=dim)
    _attach_rows(self, arrays, device)
    return self


def routed_split_from_jax(
    arrays: Mapping[str, np.ndarray | None],
    *,
    n: int,
    dim: int,
    metric: str | int,
    cls: int,
    cap: int | None = None,
    device: torch.device | str | None = None,
) -> RoutedSplitIndex:
    """The port's RoutedSplitIndex holding the JAX RoutedSplitIndex's
    state, on ``device`` (the CUDA card unless another is given):
    ``centroids``, ``comp`` (ml_dtypes bf16, carried as raw bits, or
    int8), ``aux_r``, ``gid`` and the f32 ``base`` as numpy, and optionally
    its ``sqnorms`` (else computed from the base). ``comp`` is cut to the
    port's width; the columns dropped are the JAX package's zero lane
    padding, and its ingest-pad rows past (C+1)*cap are kept."""
    device = resolve_device(device)
    mid = metric_id(metric)
    comp = _cut_to_width(np.asarray(arrays["comp"]), comp_width(dim), "comp")
    base = _to_torch(np.asarray(arrays["base"], np.float32)).to(device)
    if arrays.get("sqnorms") is not None:
        sq = _to_torch(np.asarray(arrays["sqnorms"], np.float32)).to(device)
    elif mid == METRIC_L2:
        sq = squared_norms(base)
    else:
        sq = torch.zeros(n, dtype=torch.float32, device=device)
    return RoutedSplitIndex(
        _to_torch(np.asarray(arrays["centroids"], np.float32)).to(device),
        _to_torch(comp).to(device),
        _to_torch(np.asarray(arrays["aux_r"], np.float32)).to(device),
        _to_torch(np.asarray(arrays["gid"], np.int32)).to(device),
        n, dim, mid, cls=cls, cap=cap, base_dev=base, sqnorms=sq)


def ivf_from_jax(
    arrays: Mapping[str, np.ndarray],
    *,
    metric: str | int,
    device: torch.device | str | None = None,
) -> IVFIndex:
    """The port's IVFIndex serving the JAX ``IVFData``'s layout, on
    ``device`` (the CUDA card unless another is given): its fields
    (``centroids``, ``blocks`` in ml_dtypes bf16, carried as raw bits,
    ``block_sq``, ``block_ids``, ``vectors``, ``sqnorms``) as numpy."""
    device = resolve_device(device)
    dtypes = {"centroids": np.float32, "block_sq": np.float32, "block_ids": np.int32,
              "vectors": np.float32, "sqnorms": np.float32}
    fields = {name: _to_torch(np.asarray(arrays[name], dtypes.get(name))).to(device)
              for name in IVFData._fields}
    if fields["blocks"].dtype != torch.bfloat16:
        raise ValueError(f"blocks must be bf16, got {fields['blocks'].dtype}")
    return IVFIndex.from_layout(IVFData(**fields), metric)
