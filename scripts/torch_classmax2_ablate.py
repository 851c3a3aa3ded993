"""Ablate the keep2 class-max scans on one CUDA card: what the keep2 update,
the products and (in this checkout's kernel) each phase of a member cost.

    python scripts/torch_classmax2_ablate.py --parent DIR [--reps 10]

DIR is the parent checkout, whose keep2 scan is the mma.sync kernel of
csrc/classmax_scan.cu (unpack it with ``git archive``). Each variant is a
copy of a checkout's ``shine_tpu_torch`` under ``build/ablate/`` with one
edit to its kernel source; all are built at once, each by its own copy of
``shine_tpu_torch.ops._build``. Variants:

    parent             the parent's keep2 kernel as it is
    parent_no_update   its keep2 update replaced by a sum of the scores into
                       one register (the mma stay live)
    parent_no_mma      its mma.sync dropped, the update fed the fragments' bits
    this               this checkout's kernel (csrc/classmax2_scan.cu)
    this_no_update     its keep2 update replaced as above
    this_no_wgmma      its wgmma not issued (the ring and the update run)

The keep2 scans (K2b; K3 with keep2, bf16 and int8) run at chip_smoke.py's
1M x 128 shapes (B=4096, cls=2048), each variant timed in the order of the
list and back (median of ``--reps`` CUDA-event timings after a warm-up).
The variants compute wrong results by design: nothing is compared. Then a
copy of this checkout's kernel with clock64 counters reports, per member
and CTA, the clocks its consumer warpgroups spend waiting for a full slot,
issuing the wgmma, waiting for the previous member's wgmma, and updating.
Prints one JSON line a form, the phase clocks, and the card's name, power
limit and clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.torch_classmax_ab import CLS, D, N, B, cuda_ms  # noqa: E402
from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops import _build  # noqa: E402
from shine_tpu_torch.ops import classmax as cm  # noqa: E402
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table  # noqa: E402
from shine_tpu_torch.ops.scan_split import (  # noqa: E402
    SPLIT_QUANTUM,
    pack_split_query,
    pack_split_tables,
)

OLD, NEW = "classmax_scan.cu", "classmax2_scan.cu"
_KEEP2_SELECTS = """              const bool win = v > s1[mt][nt][i];
              const bool second = !win && v > s2[mt][nt][i];
              s2[mt][nt][i] = win ? s1[mt][nt][i] : (second ? v : s2[mt][nt][i]);
              c2[mt][nt][i] = win ? c1[mt][nt][i] : (second ? m : c2[mt][nt][i]);
              s1[mt][nt][i] = win ? v : s1[mt][nt][i];
              c1[mt][nt][i] = win ? m : c1[mt][nt][i];"""
_MMA_LOOP = """      mma_tile(acc, a0, b0);
      if (ks + 1 < nks) {
        if (ks + 2 < nks) load_frags(a0, b0, qa + (ks + 2) * 16, eb + (ks + 2) * 16, qstride);
        mma_tile(acc, a1, b1);
      }"""
_UPDATE_HEAD = "    if (kc == ch.nk - 1) {  // member m is scored: the running max update\n"
_FRAG_BITS = """#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = __uint_as_float(
                (a0[mt][i] ^ b0[nt >> 1][(nt & 1) * 2 + (i & 1)] ^ a1[mt][i]) & 0x3fffffffu);
"""
_CELL = "      keep2_cell(v, code, s1[i], s2[i], c1[i], c2[i]);"
_WGMMA = "    wgmma_run<16>(x, nks, da, db, 16, 16, kc > 0);"

# (variant, checkout, source, [(old text, new text)])
VARIANTS = [
    ("parent", "parent", OLD, []),
    ("parent_no_update", "parent", OLD, [(_KEEP2_SELECTS, "              s1[0][0][0] += v;")]),
    ("parent_no_mma", "parent", OLD, [
        (_MMA_LOOP, """      if (ks + 1 < nks) {
        if (ks + 2 < nks) load_frags(a0, b0, qa + (ks + 2) * 16, eb + (ks + 2) * 16, qstride);
      }"""),
        (_UPDATE_HEAD, _UPDATE_HEAD + _FRAG_BITS)]),
    ("this", "this", NEW, []),
    ("this_no_update", "this", NEW, [(_CELL, "      s1[i] += v;")]),
    ("this_no_wgmma", "this", NEW, [(_WGMMA, "    if (nks < 0)\n  " + _WGMMA)]),
]

# clock64 counters around the consumer's phases, summed over CTAs
PHASES = [
    ("namespace {\n\nconstexpr int kTC = 64;",
     "__device__ unsigned long long g_phase[8];\n"
     "extern \"C\" int shine_phase_read(void* out) {\n"
     "  return int(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));\n}\n"
     "namespace {\n\nconstexpr int kTC = 64;"),
    ("  int slot = 0, prev = 0;\n  uint32_t ph = 0;\n",
     "  int slot = 0, prev = 0;\n  uint32_t ph = 0;\n"
     "  unsigned long long t_full = 0, t_issue = 0, t_wait = 0, t_upd = 0;\n"),
    ("    mbar_wait(full + slot, ph);\n",
     "    const unsigned long long t0 = clock64();\n    mbar_wait(full + slot, ph);\n"
     "    const unsigned long long t1 = clock64();\n    t_full += t1 - t0;\n"),
    ("    wgmma_commit();\n  };", "    wgmma_commit();\n    t_issue += clock64() - t1;\n  };"),
]
for _note, _acc in (("m-1, in acc_a", "acc_a, m - 1"), ("m, in acc_b", "acc_b, m")):
    PHASES.append((
        f"        wgmma_wait<1>();  // member {_note}, is done\n"
        f"        update({_acc}, prev);\n        release(prev);\n",
        "        {\n          const unsigned long long a = clock64();\n"
        "          wgmma_wait<1>();\n          const unsigned long long b = clock64();\n"
        f"          t_wait += b - a;\n          update({_acc}, prev);\n"
        "          release(prev);\n          t_upd += clock64() - b;\n        }\n"))
PHASES.append((
    "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    const int qi = q0 + wg * 64",
    "  if ((tid & 127) == 0) {\n    atomicAdd(&g_phase[0], t_full);\n"
    "    atomicAdd(&g_phase[1], t_issue);\n    atomicAdd(&g_phase[2], t_wait);\n"
    "    atomicAdd(&g_phase[3], t_upd);\n    atomicAdd(&g_phase[4], 1ull);\n  }\n"
    "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    const int qi = q0 + wg * 64"))

_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")


def make_copy(name: str, checkout: str, source: str, edits: list) -> str:
    """build/ablate/<name>/shine_tpu_torch: the checkout's package with the
    edits made to csrc/<source>; raises if an edit's text is not there."""
    root = os.path.join(REPO, "build", "ablate", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "shine_tpu_torch"),
                    os.path.join(root, "shine_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "shine_tpu_torch", "csrc", source)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to edit is not in {source} once:\n{old}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.shine_classmax_scan.restype = i32
    lib.shine_classmax_scan.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp, vp, vp, vp]
    lib.shine_classmax_scan_split.restype = i32
    lib.shine_classmax_scan_split.argtypes = [vp, i32, vp, vp, i64, i32, i32, i32, i32,
                                              vp, vp, vp, vp, vp]
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the parent checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    checkouts = {"parent": os.path.abspath(args.parent), "this": REPO}
    roots = {name: make_copy(name, checkouts[c], src, edits)
             for name, c, src, edits in VARIANTS}
    roots["phases"] = make_copy("phases", REPO, NEW, PHASES)
    procs = {name: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, root],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, root in roots.items()}
    libs = {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: the build failed\n{err[-4000:]}")
        libs[name] = bind(out.strip().splitlines()[-1])

    dev = torch.device("cuda:0")
    ds = synthetic_dataset(n=N, dim=D, num_queries=B, seed=7, compute_gt=False)
    ext = pack_ext_table(ds.base, 0, -(-N // QUANTUM) * QUANTUM, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(ds.queries).to(dev), ext.shape[1]).to(
        torch.bfloat16)
    forms = [("classmax2_scan", lambda: cm.classmax2_scan(ext, q_ext, cls=CLS))]
    for dt in ("bf16", "int8"):
        comp, aux = pack_split_tables(ds.base, 0, -(-N // SPLIT_QUANTUM) * SPLIT_QUANTUM,
                                      comp_dtype=dt, device=dev)
        q = pack_split_query(torch.from_numpy(ds.queries).to(dev), comp.shape[1])
        forms.append((f"classmax_scan_split {dt} keep2",
                      lambda comp=comp, aux=aux, q=q: cm.classmax_scan_split(
                          comp, aux, q, cls=CLS, keep2=True)))
    names = [v[0] for v in VARIANTS]
    for form, run in forms:
        ms = {}
        for name in names + names[::-1]:
            _build._lib = libs[name]
            ms.setdefault(name, []).append(cuda_ms(run, args.reps))
        print(json.dumps({"form": form, "ms": ms}), flush=True)

    # phase clocks of K2b, one launch after a warm-up
    _build._lib = libs["phases"]
    forms[0][1]()
    torch.cuda.synchronize()
    sym = ctypes.c_ulonglong * 8
    lib = libs["phases"]
    lib.shine_phase_read.restype = ctypes.c_int
    before = sym()
    lib.shine_phase_read(ctypes.cast(before, ctypes.c_void_p))
    forms[0][1]()
    torch.cuda.synchronize()
    after = sym()
    lib.shine_phase_read(ctypes.cast(after, ctypes.c_void_p))
    d = [a - b for a, b in zip(after, before)]
    per = d[4] * (ext.shape[0] // CLS)  # consumer warpgroups x members
    print(json.dumps({"form": "classmax2_scan phases", "clocks_per_member": {
        k: d[i] / per for i, k in enumerate(("wait_full", "issue_wgmma", "wait_wgmma",
                                             "update_release"))}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
