"""ctypes binding to the port's native HNSW graph builder.

``hnsw_builder.cc`` is compiled with g++ at first use into
``build/shine_tpu_torch/`` under the repository root (beside the CUDA
kernel library), keyed on a hash of the source and the flags, so an edit
triggers a rebuild and nothing is written beside the source. The builder
(``shine_hnsw_build``), its level-0 repair on a given graph
(``shine_hnsw_repair_level0``, through ``repair_level0``) and the
reverse-edge merge of the scan-speed build (``shine_reverse_merge``, through
``reverse_merge``) are bound.
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
        lib.shine_hnsw_repair_level0.restype = ctypes.c_int64
        lib.shine_hnsw_repair_level0.argtypes = [
            f32p,  # vecs
            ctypes.c_int64,  # n
            ctypes.c_int,  # d
            ctypes.c_int,  # M
            ctypes.c_int,  # efc
            ctypes.c_int,  # metric
            ctypes.c_int32,  # entry_point
            i32p,  # levels (n,), in place
            i32p,  # neighbors0 (n, 2M), in place
        ]
        lib.shine_reverse_merge.restype = ctypes.c_int
        lib.shine_reverse_merge.argtypes = [
            i32p,  # fwd_sel (n, M)
            f32p,  # fwd_d (n, M)
            i32p,  # ids (n,)
            ctypes.c_int64,  # n
            ctypes.c_int,  # M
            ctypes.c_int,  # cap_c
            i32p,  # cand_out (n, cap_c)
            f32p,  # cd_out (n, cap_c)
            ctypes.c_int,  # threads (0 = all cores)
        ]
        _lib = lib
        return _lib


def repair_level0(vecs: np.ndarray, levels: np.ndarray, neighbors0: np.ndarray,
                  entry_point: int, *, efc: int, metric: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """The threaded build's level-0 repair run on a given graph: every
    vertex that level 0 does not reach from ``entry_point`` gets an in-edge
    from a reachable one. ``neighbors0`` is (n, 2M), -1 padded. Returns
    copies of (levels, neighbors0) after the repair and the number of
    vertices repaired."""
    lib = load()
    vecs = np.ascontiguousarray(vecs, np.float32)
    levels = np.array(levels, np.int32)
    neighbors0 = np.array(neighbors0, np.int32)
    n, d = vecs.shape
    M = neighbors0.shape[1] // 2
    repaired = lib.shine_hnsw_repair_level0(vecs, n, d, M, efc, metric, entry_point,
                                            levels, neighbors0)
    return levels, neighbors0, int(repaired)


def reverse_merge(fwd_sel: np.ndarray, fwd_d: np.ndarray, ids: np.ndarray,
                  cap_c: int, threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The native reverse-edge merge, bit-identical to
    ``models/fastbuild.py:_reverse_merge_np`` at any thread count: a counting
    sort by destination and small per-row sorts instead of three global
    lexsorts. Returns (cand (n, cap_c) int32, dists (n, cap_c) f32)."""
    lib = load()
    n, M = fwd_sel.shape
    fwd_sel = np.ascontiguousarray(fwd_sel, np.int32)
    fwd_d = np.ascontiguousarray(fwd_d, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    cand = np.empty((n, cap_c), np.int32)
    cd = np.empty((n, cap_c), np.float32)
    rc = lib.shine_reverse_merge(fwd_sel, fwd_d, ids, n, M, cap_c, cand, cd,
                                 threads)
    if rc != 0:
        raise ValueError(f"shine_reverse_merge failed (rc={rc})")
    return cand, cd

