"""Carry the JAX package's device graph over to the port.

The JAX ``DeviceGraph`` is this system's state: graph lists and stored
rows. ``device_graph_from_jax`` takes its fields as numpy arrays, so that
both packages can serve one graph, and imports nothing of JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from shine_tpu_torch.models.hnsw import DeviceGraph

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
    device: torch.device | str = "cpu",
) -> DeviceGraph:
    """The port's DeviceGraph from the JAX DeviceGraph's fields as numpy
    arrays (``{k: np.asarray(v) for k, v in g._asdict().items()}``).
    ``nbr_width`` is the true layer-0 list width (2M); a packed
    ``neighbors0`` is unpacked with it."""
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
