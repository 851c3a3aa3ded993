"""Named interval timing, as in ``shine_tpu/utils/timing.py``: accumulated
spans exported in milliseconds as a ``timings`` object, under the span
names the JAX package uses (``warmup``, ``query``, ``load_index_buffer``,
``store_index_buffer``).

A span on a CUDA device is host wall time with ``torch.cuda.synchronize``
before each clock read, so that it holds the device work its code queued.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def sync_clock(device: torch.device | None = None) -> float:
    """``time.perf_counter()`` after the device's queued work is done."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Interval:
    __slots__ = ("name", "total_s", "_t0", "count", "device")

    def __init__(self, name: str, device: torch.device | None = None):
        self.name = name
        self.total_s = 0.0
        self._t0 = None
        self.count = 0
        self.device = device

    def start(self) -> None:
        self._t0 = sync_clock(self.device)

    def stop(self) -> None:
        if self._t0 is None:
            raise RuntimeError(f"interval {self.name!r} not started")
        self.total_s += sync_clock(self.device) - self._t0
        self._t0 = None
        self.count += 1

    def add(self, seconds: float) -> None:
        self.total_s += seconds
        self.count += 1

    def clear(self) -> None:
        self.total_s = 0.0
        self._t0 = None
        self.count = 0


class Timing:
    """Registry of named intervals on ``device`` (None: the host alone);
    exports milliseconds."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self._intervals: dict[str, Interval] = {}

    def create_enroll(self, name: str) -> Interval:
        if name not in self._intervals:
            self._intervals[name] = Interval(name, self.device)
        return self._intervals[name]

    def __getitem__(self, name: str) -> Interval:
        return self.create_enroll(name)

    @contextmanager
    def measure(self, name: str):
        iv = self.create_enroll(name)
        iv.start()
        try:
            yield iv
        finally:
            iv.stop()

    def as_dict(self) -> dict[str, float]:
        return {n: round(iv.total_s * 1e3, 3) for n, iv in self._intervals.items()}

    def clear(self) -> None:
        for iv in self._intervals.values():
            iv.clear()
