"""big-ann-benchmarks binary vector files, as in ``shine_tpu/io/fbin.py``.

Format: ``[n: u32][dim: u32][n*dim elements]``, the element type given by
the extension: ``.fbin`` float32, ``.u8bin`` uint8, ``.i8bin`` int8,
``.bin`` uint32 (ground-truth ids). A file written by either package reads
the same in the other.
"""

from __future__ import annotations

import os

import numpy as np

_EXT_DTYPE = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".bin": np.uint32,
}


def _dtype_for(path: str) -> np.dtype:
    for ext, dt in _EXT_DTYPE.items():
        if path.endswith(ext):
            return np.dtype(dt)
    raise ValueError(f"cannot infer dtype from extension of {path!r}")


def read_bin_header(path: str) -> tuple[int, int]:
    """Return (n, dim) without reading the payload."""
    with open(path, "rb") as f:
        hdr = np.fromfile(f, dtype=np.uint32, count=2)
    if hdr.size != 2:
        raise ValueError(f"{path}: truncated header")
    return int(hdr[0]), int(hdr[1])


def read_bin(
    path: str,
    *,
    max_rows: int | None = None,
    row_filter: tuple[int, int] | None = None,
    widen: bool = True,
) -> np.ndarray:
    """Read a big-ann binary file into an (n, dim) array.

    ``row_filter=(shard, num_shards)`` keeps the rows with ``id %
    num_shards == shard`` (round-robin partitioning). ``widen`` converts
    integer element types to float32; ``.bin`` ids stay uint32."""
    dt = _dtype_for(path)
    n, dim = read_bin_header(path)
    data = np.memmap(path, dtype=dt, mode="r", offset=8, shape=(n, dim))
    if row_filter is not None:
        shard, num_shards = row_filter
        data = data[shard::num_shards]
    if max_rows is not None:
        data = data[:max_rows]
    out = np.asarray(data)
    if widen and out.dtype != np.float32 and not path.endswith(".bin"):
        out = out.astype(np.float32)
    return out


def write_bin(path: str, arr: np.ndarray) -> None:
    """Write a 2-D array in the element type of ``path``'s extension."""
    dt = _dtype_for(path)
    arr = np.ascontiguousarray(arr, dtype=dt)
    if arr.ndim != 2:
        raise ValueError("expected a 2-D array")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.asarray(arr.shape, dtype=np.uint32).tofile(f)
        arr.tofile(f)
