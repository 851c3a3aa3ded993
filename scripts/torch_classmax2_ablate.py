"""Ablate the scans of csrc/classmax2_scan.cu on one CUDA card: what the
update, the products and the loads of each form cost, and what the cluster
pair (two CTAs sharing each stage's load by TMA multicast) changes.

    python scripts/torch_classmax2_ablate.py --parent DIR [--reps 10]
        [--variants this_unpaired,this_pair_all,...] [--routed]

DIR is the parent checkout (unpack it with ``git archive``), timed as it
is. Each variant is a copy of a checkout's ``shine_tpu_torch`` under
``build/ablate/`` with edits to ``csrc/classmax2_scan.cu``; all are built
at once, each by its own copy of ``shine_tpu_torch.ops._build``. Variants:

    parent             the parent checkout as it is
    this               this checkout's kernel (K2a/K2c and K3 bf16 keep1 as
                       cluster pairs)
    this_no_update     every update (keep1, keep2, K5's top two) replaced by
                       a sum of the scores into one register (the products
                       stay live)
    this_no_wgmma      the wgmma not issued (the ring and the update run)
    this_loads_only    both: the producer's loads and the ring alone
    this_unpaired      no form as a cluster pair (K6 included)
    this_unpaired_loads_only  the same, loads only
    this_pair_all      every form of a bf16 table as a pair (keep2 and K5
                       too; int8 has no pair form)
    this_pair_release  the pairs' arrivals on the peer's empty barrier with
                       release at cluster scope
    this_loads_only_rowbox  loads only, the TMA box one piece of w columns a
                       row (288 bytes at dp=144) instead of w/8 pieces of 16
                       bytes (it lands row-major, which wgmma cannot read:
                       loads only); dp <= 256 only
    this_unpaired_loads_only_rowbox  the same without pairs
    this_k4_no_update  K4's update replaced by a sum of the scores
    this_k4_no_widen   K4's int8 words fed to wgmma as they are, unwidened
    this_k4_loads_only K4 without wgmma and update: the fragments are dead,
                       so the consumers only wait for each stage and free it

The forms (K2a keep1, K2b keep2, K5, K6, K3 keep1 and keep2 in bf16 and int8)
run at chip_smoke.py's 1M x 128 shapes (B=4096, cls=2048), with
``--routed`` also K4 at each routed route's launch on routed-4m
(scripts/torch_classmax_ab.py's routed forms), each variant
timed in the order of the list and back (median of ``--reps`` CUDA-event
timings after a warm-up). The ablated variants compute wrong results by
design: only the variants that change no result are compared with
``this``, bit for bit. Then a copy of this checkout's kernel with clock64
counters reports, per member and consumer warpgroup of K2a, K2b and K5,
the clocks spent waiting for a full slot, issuing the wgmma, waiting for
the previous member's wgmma, and updating. Prints one JSON line a form, the phase clocks, and the card's
name, power limit and clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.torch_classmax_ab import (  # noqa: E402
    CLS,
    D,
    N,
    B,
    bind_entries,
    cuda_ms,
    routed_forms,
)
from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.ops import _build  # noqa: E402
from shine_tpu_torch.ops import blockmax as bm  # noqa: E402
from shine_tpu_torch.ops import classmax as cm  # noqa: E402
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table  # noqa: E402
from shine_tpu_torch.ops.scan_split import (  # noqa: E402
    SPLIT_QUANTUM,
    pack_split_query,
    pack_split_tables,
)

SRC = "classmax2_scan.cu"
NO_UPDATE = [
    ("          keep2_cell(v, code, s1[i], s2[i], c1[i], c2[i]);", "          s1[i] += v;"),
    ("          keep1_cell(v, code, s1[i], c1[i]);", "          s1[i] += v;"),
    ("        keep2_cell(y[i], base + (i >> 2) * 8 + (i & 1), bv1[r], bv2[r], br1[r], br2[r]);",
     "        bv1[r] += y[i];"),
]
_WGMMA = "    wgmma_run<16>(x, nks, da, db, 16, 16, kc > 0);"
NO_WGMMA = [(_WGMMA, "    if (nks < 0)\n  " + _WGMMA)]
_PAIRED = "  return (FORM == kKeep1 || FORM == kChunks) && KIND != kSplitI8;\n"
UNPAIRED = [(_PAIRED, "  return false;\n")]
PAIR_ALL = [(_PAIRED, "  return KIND != kSplitI8;\n")]
PAIR_RELEASE = [("mbarrier.arrive.shared::cluster.b64 _, [ra];",
                 "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];")]
ROWBOX = [("""  const cuuint64_t dims[4] = {e, 8, cuuint64_t(dp) / e, cuuint64_t(n_pad) / 8};
  const cuuint64_t strides[3] = {cuuint64_t(dp) * elt, 16, cuuint64_t(dp) * elt * 8};
  const cuuint32_t box[4] = {cuuint32_t(e), 8, cuuint32_t(w / e), cuuint32_t(groups)};""",
           """  const cuuint64_t dims[4] = {cuuint64_t(dp), 8, 1, cuuint64_t(n_pad) / 8};
  const cuuint64_t strides[3] = {cuuint64_t(dp) * elt, cuuint64_t(dp) * elt * 8,
                                 cuuint64_t(dp) * elt * 8};
  const cuuint32_t box[4] = {cuuint32_t(w), 8, 1, cuuint32_t(groups)};
  (void)e;""")]

K4_NO_UPDATE = [("      keep1_cell(__fadd_rn(__fmul_rn(y[j], ax[2 + h]), ax[h]), code, s1[j], c1[j]);",
                 "      s1[j] += y[j] + ax[h];")]
K4_NO_WIDEN = [("""        bf16x4_of_s8(word_of(x[0][ks >> 2], ks & 3), lo0, hi0);
        bf16x4_of_s8(word_of(x[1][ks >> 2], ks & 3), lo1, hi1);""",
                """        lo0 = hi0 = word_of(x[0][ks >> 2], ks & 3);
        lo1 = hi1 = word_of(x[1][ks >> 2], ks & 3);""")]
_K4_WGMMA = "      wgmma_rs(x, a[ks], bdesc + uint64_t((kc * KS + ks) * 16), kc > 0 || ks > 0);"
K4_NO_WGMMA = [(_K4_WGMMA, "      if (kc < 0)\n  " + _K4_WGMMA)]

# (variant, checkout, [(old text, new text)])
VARIANTS = [
    ("parent", "parent", []),
    ("this", "this", []),
    ("this_no_update", "this", NO_UPDATE),
    ("this_no_wgmma", "this", NO_WGMMA),
    ("this_loads_only", "this", NO_UPDATE + NO_WGMMA),
    ("this_unpaired", "this", UNPAIRED),
    ("this_unpaired_loads_only", "this", UNPAIRED + NO_UPDATE + NO_WGMMA),
    ("this_pair_all", "this", PAIR_ALL),
    ("this_pair_release", "this", PAIR_RELEASE),
    ("this_loads_only_rowbox", "this", NO_UPDATE + NO_WGMMA + ROWBOX),
    ("this_unpaired_loads_only_rowbox", "this", UNPAIRED + NO_UPDATE + NO_WGMMA + ROWBOX),
    ("this_k4_no_update", "this", K4_NO_UPDATE),
    ("this_k4_no_widen", "this", K4_NO_WIDEN),
    ("this_k4_loads_only", "this", K4_NO_UPDATE + K4_NO_WGMMA),
]

# clock64 counters around the consumer's phases, summed over CTAs
PHASES = [
    ("namespace {\n\n__device__ __forceinline__ uint32_t smem_addr",
     "__device__ unsigned long long g_phase[8];\n"
     "extern \"C\" int shine_phase_read(void* out) {\n"
     "  return int(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));\n}\n"
     "namespace {\n\n__device__ __forceinline__ uint32_t smem_addr"),
    ("  int slot = 0, prev = 0;\n  uint32_t ph = 0;\n",
     "  int slot = 0, prev = 0;\n  uint32_t ph = 0;\n"
     "  unsigned long long t_full = 0, t_issue = 0, t_wait = 0, t_upd = 0;\n"),
    ("  auto issue = [&](float (&x)[32], int kc) {\n    mbar_wait(full + slot, ph);\n",
     "  auto issue = [&](float (&x)[32], int kc) {\n"
     "    const unsigned long long t0 = clock64();\n    mbar_wait(full + slot, ph);\n"
     "    const unsigned long long t1 = clock64();\n    t_full += t1 - t0;\n"),
    ("kc > 0);\n    wgmma_commit();\n  };",
     "kc > 0);\n    wgmma_commit();\n    t_issue += clock64() - t1;\n  };"),
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
    "  if constexpr (!kBlockWalk && !kChunkWalk) {\n#pragma unroll\n"
    "    for (int h = 0; h < 2; ++h) {",
    "  if ((tid & 127) == 0) {\n    atomicAdd(&g_phase[0], t_full);\n"
    "    atomicAdd(&g_phase[1], t_issue);\n    atomicAdd(&g_phase[2], t_wait);\n"
    "    atomicAdd(&g_phase[3], t_upd);\n    atomicAdd(&g_phase[4], 1ull);\n"
    "    atomicAdd(&g_phase[5], (unsigned long long)count);\n  }\n"
    "  if constexpr (!kBlockWalk && !kChunkWalk) {\n#pragma unroll\n"
    "    for (int h = 0; h < 2; ++h) {"))

_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")


def make_copy(name: str, checkout: str, edits: list) -> str:
    """build/ablate/<name>/shine_tpu_torch: the checkout's package with the
    edits made to csrc/classmax2_scan.cu; raises if an edit's text is not
    there."""
    root = os.path.join(REPO, "build", "ablate", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "shine_tpu_torch"),
                    os.path.join(root, "shine_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "shine_tpu_torch", "csrc", SRC)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to edit is not in {SRC} once:\n{old}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def phase_clocks(lib: ctypes.CDLL, run) -> dict:
    """The consumer's phase clocks a member and warpgroup over one launch."""
    sym = ctypes.c_ulonglong * 8
    lib.shine_phase_read.restype = ctypes.c_int
    run()
    torch.cuda.synchronize()
    before = sym()
    lib.shine_phase_read(ctypes.cast(before, ctypes.c_void_p))
    run()
    torch.cuda.synchronize()
    after = sym()
    lib.shine_phase_read(ctypes.cast(after, ctypes.c_void_p))
    d = [a - b for a, b in zip(after, before)]
    return {k: d[i] / d[5] for i, k in enumerate(("wait_full", "issue_wgmma", "wait_wgmma",
                                                 "update_release"))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the parent checkout")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--routed", action="store_true", help="K4's routed forms too")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to time, 'phases' for the clock "
                         "counters (default: all; 'this' always runs)")
    args = ap.parse_args()
    wanted = ({name for name, _, _ in VARIANTS} | {"phases"} if args.variants is None
              else {"this", *args.variants.split(",")})
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    checkouts = {"parent": os.path.abspath(args.parent), "this": REPO}
    variants = [v for v in VARIANTS if v[0] in wanted]
    roots = {name: make_copy(name, checkouts[c], edits) for name, c, edits in variants}
    if "phases" in wanted:
        roots["phases"] = make_copy("phases", REPO, PHASES)
    procs = {name: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, root],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, root in roots.items()}
    libs = {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: the build failed\n{err[-4000:]}")
        libs[name] = bind_entries(ctypes.CDLL(out.strip().splitlines()[-1]))

    dev = torch.device("cuda:0")
    ds = synthetic_dataset(n=N, dim=D, num_queries=B, seed=7, compute_gt=False)
    ext = pack_ext_table(ds.base, 0, -(-N // QUANTUM) * QUANTUM, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(ds.queries).to(dev), ext.shape[1]).to(
        torch.bfloat16)
    forms = [("classmax_scan keep1", lambda: cm.classmax_scan(ext, q_ext, cls=CLS)),
             ("classmax2_scan", lambda: cm.classmax2_scan(ext, q_ext, cls=CLS)),
             ("blockmax_scan", lambda: bm.blockmax_scan(ext, q_ext)),
             ("blockmax_scan2", lambda: bm.blockmax_scan2(ext, q_ext))]
    for dt in ("bf16", "int8"):
        comp, aux = pack_split_tables(ds.base, 0, -(-N // SPLIT_QUANTUM) * SPLIT_QUANTUM,
                                      comp_dtype=dt, device=dev)
        q = pack_split_query(torch.from_numpy(ds.queries).to(dev), comp.shape[1])
        forms += [(f"classmax_scan_split {dt} keep{2 if k2 else 1}",
                   lambda comp=comp, aux=aux, q=q, k2=k2: cm.classmax_scan_split(
                       comp, aux, q, cls=CLS, keep2=k2)) for k2 in (False, True)]
    if args.routed:
        _build._lib = libs["this"]
        forms += routed_forms(dev, np.random.default_rng(7))
    names = [v[0] for v in variants]
    exact = [n for n in names if n in ("this", "this_unpaired", "this_pair_all",
                                       "this_pair_release")]
    for form, run in forms:
        ms, outs = {}, {}
        for name in names + names[::-1]:
            _build._lib = libs[name]
            if name in exact:
                outs[name] = run()
            ms.setdefault(name, []).append(cuda_ms(run, args.reps))
        equal = {n: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(outs["this"], outs[n])) for n in exact[1:]}
        print(json.dumps({"form": form, "ms": ms, "equal_to_this": equal}), flush=True)

    _build._lib = libs.get("phases")
    for form, run in forms[:3] if "phases" in wanted else []:
        print(json.dumps({"form": f"{form} phases",
                          "clocks_per_member": phase_clocks(libs["phases"], run)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
