"""Time K1 of two checkouts of the PyTorch port on one CUDA card, in turns:
``gather_score`` and, where both checkouts have it, the fused ``beam_step``.

    python scripts/torch_k1_ab.py --base DIR [--reps 20]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``). Each checkout's ``csrc`` is built into its
own library by its own ``shine_tpu_torch.ops._build``; the inputs are this
checkout's. ``gather_score`` runs at chip_smoke.py's phase-3 shapes (the
1,000,000 x 128 set's rows, B=4096 queries, K=256 lanes, ~10% of them
masked) on f32, bf16 and int8 rows under L2. ``beam_step`` runs one step
(step 8) of a batch of 4096 queries over the same rows, on layer-0 lists of
random ids (W=32, the 1M graph's width) at ef=96, frontier=8, k=10, from a
beam seeded with two random ids a query and advanced by this checkout's
kernel; random lists keep nearly every lane, as step 8 of the 1M graph
does (chip_smoke.py phase 19). Each library starts every run from the same
state, and the two libraries' outputs must agree bit for bit (float words
as int32). The order is base, this, this, base, each time the median of
``--reps`` CUDA-event timings after a warm-up. Prints one JSON line a form,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shine_tpu_torch.config import METRIC_L2, SearchParams  # noqa: E402
from shine_tpu_torch.io import synthetic_dataset  # noqa: E402
from shine_tpu_torch.models import hnsw as th  # noqa: E402
from shine_tpu_torch.ops import beam_step as bs  # noqa: E402
from shine_tpu_torch.ops.beam import Beam  # noqa: E402
from shine_tpu_torch.ops.gather_score import ROW_TYPES, gather_score  # noqa: E402

N, D, B, K, SEED = 1_000_000, 128, 4096, 256, 7
W, STEP = 32, 8
SEARCH = SearchParams(k=10, ef=96, frontier=8).resolved()
_BUILD_ONE = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from shine_tpu_torch.ops import _build; _build.load(); "
              "print(_build.lib_path())")


def bind(path: str) -> ctypes.CDLL:
    """The library at ``path`` with K1's entry points bound (their C
    signatures are the same in every checkout that has them)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = ctypes.CDLL(path)
    lib.shine_gather_score.restype = i32
    lib.shine_gather_score.argtypes = [vp, i32, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                                       i32, i32, vp]
    if hasattr(lib, "shine_beam_step"):
        lib.shine_beam_step.restype = i32
        lib.shine_beam_step.argtypes = [vp, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                        vp, i32, i64, i32, i32, i32, i32, i32, i32, i32,
                                        vp]
    return lib


def build_libs(checkouts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    procs = {k: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, path],
                                 stdout=subprocess.PIPE, text=True)
             for k, path in checkouts.items()}
    libs = {}
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"the {k} checkout's kernels did not build")
        libs[k] = bind(out.strip().splitlines()[-1])
    return libs


def event_ms(fn, reps: int, before=None) -> float:
    times = []
    for i in range(reps + 3):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise SystemExit(f"{what}: CUDA error {rc} at launch")


def make_inputs() -> dict:
    """The set's rows and queries, the masked lanes of gather_score, the
    random lists and the seeds of beam_step, on the card."""
    dev = torch.device("cuda")
    ds = synthetic_dataset(n=N, dim=D, num_queries=B, seed=SEED, compute_gt=False)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, N, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    q_ext, bias = th._extend_query(torch.from_numpy(ds.queries).to(dev), METRIC_L2)
    return {
        "base": ds.base, "q_ext": q_ext, "bias": bias,
        "ids": torch.from_numpy(ids).to(dev),
        "lists": torch.from_numpy(rng.integers(0, N, size=(N, W)).astype(np.int32)).to(dev),
        "seeds": torch.from_numpy(rng.integers(0, N, size=(B, 2)).astype(np.int32)).to(dev),
        "stream": torch.cuda.current_stream().cuda_stream,
    }


def row_tables(inp: dict, rows: str) -> dict:
    t = {k: v.cuda() for k, v in th.quantize_rows(inp["base"], rows).items()}
    return {"vectors": t["vectors_ext"], "scl": t.get("row_scl"), "nrm": t.get("row_nrm")}


def step_state(inp: dict, rows: str) -> tuple[dict, list, list]:
    """(tables, state, snapshot): the layer-0 state at step STEP, advanced
    from the seeds by this checkout's kernel, and a copy of it."""
    tb = row_tables(inp, rows)
    seed_d = gather_score(tb["vectors"], inp["q_ext"], inp["bias"], inp["seeds"],
                          row_scl=tb["scl"], row_nrm=tb["nrm"])
    state = list(th._l0_state(inp["seeds"], seed_d, SEARCH))
    for t in range(STEP):
        bs.beam_step(tb["vectors"], inp["lists"], inp["q_ext"], inp["bias"], *state, t,
                     frontier=SEARCH.frontier, k=SEARCH.k, term=SEARCH.term,
                     row_scl=tb["scl"], row_nrm=tb["nrm"])
    snap = [Beam(*(c.clone() for c in state[0]))] + [x.clone() for x in state[1:]]
    return tb, state, snap


def _flat(state) -> list[torch.Tensor]:
    return list(state[0]) + list(state[1:])


def time_step(lib, inp: dict, tb: dict, state: list, snap: list, reps: int) -> float:
    """Median time of ``lib``'s beam_step at step STEP, the state restored
    from ``snap`` before each run; the state is left one step on."""
    beam, hops, counts, uns = state
    v = tb["vectors"]

    def restore():
        for x, y in zip(_flat(state), _flat(snap)):
            x.copy_(y)

    def step():
        _check(lib.shine_beam_step(
            v.data_ptr(), ROW_TYPES[v.dtype], inp["q_ext"].data_ptr(),
            inp["bias"].data_ptr(), _ptr(tb["scl"]), _ptr(tb["nrm"]),
            inp["lists"].data_ptr(), beam.dists.data_ptr(), beam.ids.data_ptr(),
            beam.expanded.data_ptr(), hops.data_ptr(), counts.data_ptr(),
            uns.data_ptr(), STEP, N, B, SEARCH.ef, SEARCH.frontier, W, D, SEARCH.ef,
            1, inp["stream"]), "beam_step")

    return event_ms(step, reps, before=restore)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab.py needs a CUDA card")
    libs = build_libs({"base": os.path.abspath(args.base), "this": REPO})
    inp = make_inputs()
    both_steps = all(hasattr(lib, "shine_beam_step") for lib in libs.values())
    order = ("base", "this", "this", "base")
    for rows in ("f32", "bf16", "int8"):
        tb = row_tables(inp, rows)
        v = tb["vectors"]
        outs = {k: torch.empty((B, K), dtype=torch.float32, device="cuda") for k in libs}

        def gather(k):
            _check(libs[k].shine_gather_score(
                v.data_ptr(), ROW_TYPES[v.dtype], inp["q_ext"].data_ptr(),
                inp["bias"].data_ptr(), inp["ids"].data_ptr(), _ptr(tb["scl"]),
                _ptr(tb["nrm"]), outs[k].data_ptr(), N, B, K, D, 1, inp["stream"]),
                "gather_score")

        times = {k: [] for k in libs}
        for k in order:
            times[k].append(event_ms(lambda: gather(k), args.reps))
        diff = float((outs["base"] - outs["this"]).abs().nan_to_num(0.0).max())
        print(json.dumps({"kernel": "gather_score", "rows": rows, "ms": times,
                          "max_abs_diff": diff,
                          "same_bits": torch.equal(outs["base"].view(torch.int32),
                                                   outs["this"].view(torch.int32))}),
              flush=True)
        del tb, v
        if not both_steps:
            continue
        tb, state, snap = step_state(inp, rows)
        times, got = {k: [] for k in libs}, {}
        for k in order:
            times[k].append(time_step(libs[k], inp, tb, state, snap, args.reps))
            got[k] = [x.clone() for x in _flat(state)]
        same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
                   for a, b in zip(got["base"], got["this"]))
        print(json.dumps({"kernel": "beam_step", "rows": rows, "step": STEP,
                          "ms": times, "same_bits": same}), flush=True)
        if not same:
            raise SystemExit(f"beam_step {rows}: the two checkouts disagree")
        del tb, state, snap
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
