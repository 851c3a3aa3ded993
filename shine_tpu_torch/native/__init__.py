"""ctypes binding to the port's native HNSW graph builder.

``hnsw_builder.cc`` is compiled with g++ at first use into
``build/shine_tpu_torch/`` under the repository root (beside the CUDA
kernel library), keyed on a hash of the source and the flags, so an edit
triggers a rebuild and nothing is written beside the source. Only the
builder (``shine_hnsw_build``) is bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hnsw_builder.cc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "shine_tpu_torch")
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++20",
             "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(_BUILD, f"libshine_native_{h.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The native library, built from the checkout's source on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.shine_hnsw_build.restype = ctypes.c_int
        lib.shine_hnsw_build.argtypes = [
            f32p,  # vecs
            ctypes.c_int64,  # n
            ctypes.c_int,  # d
            ctypes.c_int,  # M
            ctypes.c_int,  # efc
            ctypes.c_uint64,  # seed
            ctypes.c_int,  # metric
            ctypes.c_int,  # threads
            ctypes.c_int64,  # upper_cap
            ctypes.c_int,  # level_cap
            i32p,  # levels
            i32p,  # neighbors0
            i32p,  # upper_row
            i32p,  # upper_neighbors
            i64p,  # meta
        ]
        _lib = lib
        return _lib

