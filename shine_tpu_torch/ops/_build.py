"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes. No PyTorch header is included, so
the build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` needs. The library lands in
``build/shine_tpu_torch/`` under the repository root, keyed on a hash of
the sources, and is built at first use: nothing happens at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "shine_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # each kernel's registers and spills, into build_log
]
# flags of one source only: regen_rows.cu rounds every f32 multiply and add
# on its own, as torch's elementwise ops do, to equal its plain version
FILE_FLAGS = {"regen_rows.cu": ["-fmad=false"]}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build
build_log = ""  # the compilers' remarks of the last build


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def lib_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(FILE_FLAGS.items())).encode())
    return os.path.join(_BUILD, f"libshine_kernels_{h.hexdigest()[:12]}.so")


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; raise on the first that fails. Returns
    each one's standard error (the compiler's remarks)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = []
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            for other in procs:
                other.kill()
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{err}")
        errs.append(err)
    return errs


def _build(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(os.path.basename(src), []),
                         "-c", "-o", obj, src]
                        for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(log)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.shine_gather_score.restype = i32
    lib.shine_gather_score.argtypes = [
        vp,  # vectors (N, d): f32 | bf16 | int8
        i32,  # row type: 0 f32, 1 bf16, 2 int8
        vp,  # q_ext (B, d) f32
        vp,  # bias (B,) f32
        vp,  # ids (B, K) i32
        vp,  # row_scl (N,) f32 or null
        vp,  # row_nrm (N,) f32 or null
        vp,  # out (B, K) f32
        i64,  # N
        i32,  # B
        i32,  # K
        i32,  # d
        i32,  # l2
        vp,  # cudaStream_t
    ]
    lib.shine_beam_step_smem.restype = i64
    lib.shine_beam_step_smem.argtypes = [i32, i32, i32, i32]  # ef, E, W, d
    lib.shine_beam_step.restype = i32
    lib.shine_beam_step.argtypes = [
        vp,  # vectors (N, d): f32 | bf16 | int8
        i32,  # row type: 0 f32, 1 bf16, 2 int8
        vp,  # q_ext (B, d) f32
        vp,  # bias (B,) f32
        vp,  # row_scl (N,) f32 or null
        vp,  # row_nrm (N,) f32 or null
        vp,  # neighbors0 (N, W) i32
        vp,  # beam dists (B, ef) f32, in place
        vp,  # beam ids (B, ef) i32, in place
        vp,  # beam expanded (B, ef) bool, in place
        vp,  # hops (B,) i32, in place
        vp,  # distance counts (B,) i32, in place
        vp,  # unsettled (steps + 1,) i32
        i32,  # t
        i64,  # N
        i32,  # B
        i32,  # ef
        i32,  # E, the frontier
        i32,  # W, the list width
        i32,  # d
        i32,  # settle: k (term "k") or ef (term "ef")
        i32,  # l2
        vp,  # cudaStream_t
    ]
    lib.shine_classmax_scan.restype = i32
    lib.shine_classmax_scan.argtypes = [
        vp,  # ext (N_pad, dp) bf16
        vp,  # q (B, dp) bf16
        i64,  # N_pad
        i32,  # B
        i32,  # dp
        i32,  # cls
        i32,  # keep2
        vp,  # best (B, cls) f32
        vp,  # rows (B, cls) i32
        vp,  # best2 (B, cls) f32 or null
        vp,  # rows2 (B, cls) i32 or null
        vp,  # cudaStream_t
    ]
    lib.shine_classmax_scan_split.restype = i32
    lib.shine_classmax_scan_split.argtypes = [
        vp,  # comp (N_pad, dpc) bf16 | int8
        i32,  # comp is int8
        vp,  # aux (2, N_pad) f32: nrm, scl
        vp,  # q (B, dpc) bf16
        i64,  # N_pad
        i32,  # B
        i32,  # dpc
        i32,  # cls
        i32,  # keep2
        vp,  # best (B, cls) f32
        vp,  # rows (B, cls) i32
        vp,  # best2 (B, cls) f32 or null
        vp,  # rows2 (B, cls) i32 or null
        vp,  # cudaStream_t
    ]
    lib.shine_classmax_scan_routed.restype = i32
    lib.shine_classmax_scan_routed.argtypes = [
        vp,  # comp ((C+1)*cap or more, dpc) bf16 | int8
        i32,  # comp is int8
        vp,  # aux_r (C+1, 2*cap/cls, cls) f32
        vp,  # q (G*T, dpc) bf16
        vp,  # cols (G, P) i32
        i32,  # C, the pad cluster
        i32,  # G
        i32,  # T
        i32,  # P
        i32,  # dpc
        i32,  # cap
        i32,  # cls
        vp,  # best (G*T, cls) f32
        vp,  # rows (G*T, cls) i32
        vp,  # cudaStream_t
    ]
    lib.shine_blockmax_scan.restype = i32
    lib.shine_blockmax_scan.argtypes = [
        vp,  # ext (N_pad, dp) bf16
        vp,  # q (B, dp) bf16
        i64,  # N_pad
        i32,  # B
        i32,  # dp
        vp,  # max1 (B, N_pad/128) f32
        vp,  # arg1 (B, N_pad/128) i32
        vp,  # max2 (B, N_pad/128) f32
        vp,  # arg2 (B, N_pad/128) i32
        vp,  # cudaStream_t
    ]
    lib.shine_blockmax_scan2.restype = i32
    lib.shine_blockmax_scan2.argtypes = [
        vp,  # ext (N_pad, dp) bf16
        vp,  # q (B, dp) bf16
        i64,  # N_pad
        i32,  # B
        i32,  # dp
        vp,  # max1 (B, N_pad/32) f32
        vp,  # arg1 (B, N_pad/32) i32
        vp,  # cudaStream_t
    ]
    u32 = ctypes.c_uint32
    lib.shine_regen_rows.restype = i32
    lib.shine_regen_rows.argtypes = [
        u32,  # key word 0
        u32,  # key word 1
        vp,  # centers (nc, d) f32
        i32,  # nc
        i32,  # d
        vp,  # ids (m,) i32
        i64,  # m
        i32,  # normalize
        vp,  # out (m, d) f32
        vp,  # cudaStream_t
    ]
    lib.shine_regen_score.restype = i32
    lib.shine_regen_score.argtypes = [
        u32,  # key word 0
        u32,  # key word 1
        vp,  # centers (nc, d) f32
        i32,  # nc
        i32,  # d
        vp,  # q (B, d) f32
        vp,  # cand_ids (B, K) i32
        i32,  # B
        i32,  # K
        i32,  # ip
        vp,  # out (B, K) f32
        vp,  # cudaStream_t
    ]
    lib.shine_classmax_select.restype = i32
    lib.shine_classmax_select.argtypes = [
        vp,  # best (B, cls) f32
        vp,  # rows (B, cls) i32
        vp,  # best2 (B, cls) f32 or null
        vp,  # rows2 (B, cls) i32 or null
        i32,  # B
        i32,  # cls
        i32,  # kb
        vp,  # out best (B, kb) f32
        vp,  # out rows (B, kb) i32
        vp,  # out best2 (B, kb) f32 or null
        vp,  # out rows2 (B, kb) i32 or null
        vp,  # cudaStream_t
    ]


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
