"""What the measuring scripts and ``chip_smoke.py`` read off a run, in one
place: each kernel wrapper's launch count, the least time an H100 SXM could
take for a piece of work (its bound), and the records' card line, peak
memory and best-of-passes QPS."""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from shine_tpu_torch.ops import beam_step as _bs
from shine_tpu_torch.ops import blockmax as _bm
from shine_tpu_torch.ops import classmax as _cm
from shine_tpu_torch.ops import regen as _rg
from shine_tpu_torch.ops import scan_routed as _k4
from shine_tpu_torch.ops.gather_score import gather_score as _gather_score
from shine_tpu_torch.utils.timing import sync_clock

# H100 SXM data sheet: HBM bytes/s, dense bf16 and fp32 (CUDA core) FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12

# every kernel wrapper, by the name its launches are reported under
KERNELS = {
    "gather_score": _gather_score,
    "beam_step": _bs.beam_step,
    "routed_classmax_scan": _k4.routed_classmax_scan,
    **{f.__name__: f for f in (
        _cm.classmax_scan, _cm.classmax2_scan, _cm.classmax_topk_scan,
        _cm.classmax2_topk_scan, _cm.classmax_scan_split, _cm.classmax_topk_scan_split,
        _bm.blockmax_scan, _bm.blockmax_scan2, _rg.regen_rows, _rg.regen_score)},
}


def reset_launches() -> None:
    """Every wrapper's count (and its count by form, where it keeps one) to 0."""
    for f in KERNELS.values():
        f.launches = 0
        if hasattr(f, "form_launches"):
            f.form_launches.clear()


def launches() -> dict[str, int]:
    """Each wrapper's launches since ``reset_launches``, those above 0."""
    return {k: f.launches for k, f in KERNELS.items() if f.launches}


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger; (ms, "bytes" or
    "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(rows: int, queries: int, width: int, row_bytes: int,
               outputs: int) -> tuple[float, str]:
    """A class-max scan's bound (K2, K3, K5, K6): the ``rows`` real rows of
    ``row_bytes`` each read once (a table's zero columns and pad rows add
    no work), the bf16 queries at ``width``, ``outputs`` 4-byte results
    written once; 2 * queries * rows * width bf16 operations."""
    nbytes = rows * row_bytes + queries * width * 2 + outputs * 4
    return bound_ms(nbytes, 2.0 * queries * rows * width, PEAK_BF16)


def card_line(dev: torch.device) -> str | None:
    """``name, power limit`` as nvidia-smi gives them, on a card."""
    if dev.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


class Recorder:
    """Prints each record after ``# `` and appends it as one JSON line to
    ``out``, after the fields of ``head``."""

    def __init__(self, out: str, head: dict):
        self.out, self.head = out, head

    def __call__(self, rec: dict) -> dict:
        rec = {**self.head, **rec}
        print("#", json.dumps(rec), flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
        with open(self.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def best_qps(run, nq: int, dev: torch.device, reps: int = 2):
    """One warm-up pass, then the best of ``reps`` timed passes: (ids, qps)."""
    ids, _ = run()
    best = float("inf")
    for _ in range(reps):
        t0 = sync_clock(dev)
        ids, _ = run()
        best = min(best, sync_clock(dev) - t0)
    return ids, nq / best


def latency_walls(fn, dev: torch.device, reps: int = 40, warmup: int = 2) -> list[float]:
    """``warmup`` untimed calls of ``fn()``, then the wall of each of
    ``reps`` calls in ms, in call order, on the synchronised host clock."""
    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(reps):
        t0 = sync_clock(dev)
        fn()
        walls.append((sync_clock(dev) - t0) * 1e3)
    return walls


def p50_p99(walls: list[float]) -> tuple[float, float]:
    """``bench.py``'s low-batch latency rule: of the walls sorted, element
    len // 2 and element min(len - 1, int(len * 0.99))."""
    s = sorted(walls)
    return s[len(s) // 2], s[min(len(s) - 1, int(len(s) * 0.99))]


def peak_gb(dev: torch.device) -> float | None:
    """The card's peak allocated memory since its last reset, GB."""
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def reset_peak(dev: torch.device) -> None:
    """Start the card's peak-memory count anew (a stage's own peak)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def event_ms(fn, reps: int = 5) -> float:
    """The median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_once(fn, top: int = 10) -> dict:
    """``fn()`` once under torch.profiler on the card: device time by kernel
    (the ``top`` longest), their sum and its share of the call's span."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    return {"span_ms": span, "busy_ms": busy, "busy_share": busy / span,
            "kernels": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:top]]}
