"""Index and search configuration of the port: its own copy of the metric
ids and the two parameter dataclasses of ``shine_tpu/config.py``, with the
same fields, defaults and validation, so that one set of parameters means
the same search in both packages, and the command line's ``--index auto``
rule (``auto_index_family``).
"""

from __future__ import annotations

import dataclasses
import math
import os

METRIC_L2 = 0  # squared L2
METRIC_IP = 1  # 1 - <a, b>

_METRIC_NAMES = {"l2": METRIC_L2, "ip": METRIC_IP}


# --index auto family thresholds (rows per card): the JAX package's rule
# (shine_tpu/config.py), kept so that both command lines pick the same family
# for the same set. The JAX package set them from its own measurements: the
# packed-bf16 FastFlat scan as the speed family up to 20M rows, the routed
# split layout up to 64M, the exact int8 split scan above. They have not been
# measured on the CUDA card. SHINE_AUTO_FASTFLAT_MAX and SHINE_AUTO_ROUTED_MAX
# override them, as in the JAX package.
AUTO_FASTFLAT_MAX_ROWS = 20e6
AUTO_ROUTED_MAX_ROWS = 64e6


def auto_index_family(n_rows: int, shards: int = 1) -> str:
    """The --index auto rule: fastflat up to AUTO_FASTFLAT_MAX_ROWS rows per
    card, routed up to AUTO_ROUTED_MAX_ROWS, split above."""
    per_chip = n_rows / max(shards, 1)
    fmax = float(os.environ.get("SHINE_AUTO_FASTFLAT_MAX",
                                AUTO_FASTFLAT_MAX_ROWS))
    rmax = float(os.environ.get("SHINE_AUTO_ROUTED_MAX",
                                AUTO_ROUTED_MAX_ROWS))
    if per_chip <= fmax:
        return "fastflat"
    if per_chip <= rmax:
        return "routed"
    return "split"


def metric_id(metric: str | int) -> int:
    if isinstance(metric, int):
        if metric not in (METRIC_L2, METRIC_IP):
            raise ValueError(f"unknown metric id {metric}")
        return metric
    try:
        return _METRIC_NAMES[metric.lower()]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; expected 'l2' or 'ip'") from None


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    """Build-time parameters of the graph: M_max = M on the upper layers,
    M_max0 = 2M on layer 0, m_L = 1/ln(M) for the geometric level draw."""

    M: int = 32
    ef_construction: int = 500
    metric: str = "l2"
    seed: int = 42

    @property
    def M_max(self) -> int:
        return self.M

    @property
    def M_max0(self) -> int:
        return 2 * self.M

    @property
    def m_L(self) -> float:
        return 1.0 / math.log(self.M)

    @property
    def metric_id(self) -> int:
        return metric_id(self.metric)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Query-time parameters.

    ef: beam width of the layer-0 search; k: result count; frontier:
    unexpanded beam entries expanded per step; max_steps: bound on the
    steps (0 = auto); entry_mode: "dense" (one sweep over the upper-level
    vertices seeds the beam with ``entry_seeds`` entries) or "descent"
    (greedy walk down the upper levels); term: "ef" (stop when every beam
    entry is expanded) or "k" (when the top-k prefix is). ``pallas_gather``,
    ``exchange``, ``exchange_slack`` and ``adaptive_slack`` select TPU and
    sharded variants; the port accepts and ignores them.
    """

    k: int = 10
    ef: int = 128
    frontier: int = 4
    max_steps: int = 0
    pallas_gather: bool = False
    entry_mode: str = "dense"
    entry_seeds: int = 2
    term: str = "ef"
    exchange: str = "dense"
    exchange_slack: float = 2.0
    adaptive_slack: bool = False

    def resolved(self) -> "SearchParams":
        if self.frontier < 1:
            raise ValueError("frontier must be >= 1")
        if self.entry_mode not in ("dense", "descent"):
            raise ValueError("entry_mode must be 'dense' or 'descent'")
        if self.term not in ("ef", "k"):
            raise ValueError("term must be 'ef' or 'k'")
        if self.exchange not in ("dense", "compact"):
            raise ValueError("exchange must be 'dense' or 'compact'")
        ms = self.max_steps or (2 * ((self.ef + 31) // self.frontier) + 8)
        if self.k > self.ef:
            raise ValueError("k must be <= ef")
        return dataclasses.replace(self, max_steps=ms)
