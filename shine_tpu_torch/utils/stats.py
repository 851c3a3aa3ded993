"""Run statistics in the reference's JSON result schema, as in
``shine_tpu/utils/stats.py``: ``meta``, ``hnsw_parameters``, ``build``,
``queries``, ``cache`` and ``timings``, with the same keys, so that one
reader takes either package's document. ``meta.framework`` is
``shine_tpu_torch``, and ``meta.device``, the one key the port adds, names
the card the numbers came from (``torch.cuda.get_device_name``) or
``cpu``.

Counters: expansions are the HNSW frontier expansions, distance
computations the exact count of scored lanes; a dense family's counters
are analytic in its shapes (its ``cost_counters``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

from shine_tpu_torch.config import HNSWParams, SearchParams


@dataclasses.dataclass
class SearchStats:
    """Aggregated query-phase counters."""

    num_queries: int = 0
    expansions: int = 0  # frontier expansions (~ visited nodes on layer 0)
    distance_computations: int = 0
    scanned_rows: int = 0  # dense-scan rows scored (the flat families)
    steps: int = 0  # sequential traversal steps executed
    hbm_gather_bytes: int = 0
    ici_exchange_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    query_seconds: float = 0.0
    recall: float | None = None

    def add_batch(
        self,
        batch: int,
        hops_sum: int,
        steps: int,
        cand_lanes: int,
        row_bytes: int,
        seconds: float,
        ici_bytes: int = 0,
    ) -> None:
        self.num_queries += batch
        self.expansions += hops_sum
        self.distance_computations += hops_sum * cand_lanes
        self.steps += steps
        self.hbm_gather_bytes += hops_sum * cand_lanes * row_bytes
        self.ici_exchange_bytes += ici_bytes
        self.query_seconds += seconds

    @property
    def qps(self) -> float:
        return self.num_queries / self.query_seconds if self.query_seconds else 0.0

    @property
    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0


class Statistics:
    """The run-level JSON document."""

    def __init__(
        self,
        *,
        dataset: str = "",
        label: str = "",
        num_shards: int = 1,
        zipf: float = 0.0,
        device: str = "cpu",
    ):
        self.meta: dict[str, Any] = {
            "dataset": dataset,
            "label": label,
            "num_shards": num_shards,
            "zipf": zipf,
            "timestamp": int(time.time()),
            "framework": "shine_tpu_torch",
            "device": device,
        }
        self.hnsw_parameters: dict[str, Any] = {}
        self.build: dict[str, Any] = {}
        self.queries: dict[str, Any] = {}
        self.cache: dict[str, Any] = {}
        self.timings: dict[str, float] = {}

    def set_params(self, params: HNSWParams, sp: SearchParams | None = None) -> None:
        self.hnsw_parameters = {
            "m": params.M,
            "m_max": params.M_max,
            "m_max0": params.M_max0,
            "ef_construction": params.ef_construction,
            "metric": params.metric,
            "seed": params.seed,
        }
        if sp is not None:
            sp = sp.resolved()
            self.hnsw_parameters.update(
                {"k": sp.k, "ef_search": sp.ef, "frontier": sp.frontier}
            )

    def set_build(self, *, num_vectors: int, build_seconds: float, index_bytes: int) -> None:
        self.build = {
            "num_vectors": num_vectors,
            "build_time_ms": round(build_seconds * 1e3, 1),
            "inserts_per_sec": round(num_vectors / build_seconds, 1)
            if build_seconds
            else 0.0,
            "index_size_in_bytes": index_bytes,
        }

    def set_queries(self, s: SearchStats) -> None:
        self.queries = {
            "num_queries": s.num_queries,
            "queries_per_sec": round(s.qps, 1),
            "query_time_ms": round(s.query_seconds * 1e3, 1),
            "recall": s.recall,
            "expansions": s.expansions,
            "distance_computations": s.distance_computations,
            "scanned_rows": s.scanned_rows,
            "traversal_steps": s.steps,
            "hbm_gather_bytes": s.hbm_gather_bytes,
            "ici_exchange_bytes": s.ici_exchange_bytes,
        }
        self.cache = {
            "hits": s.cache_hits,
            "misses": s.cache_misses,
            "hit_rate": round(s.cache_hit_rate, 4),
        }

    def as_dict(self) -> dict[str, Any]:
        return {
            "meta": self.meta,
            "hnsw_parameters": self.hnsw_parameters,
            "build": self.build,
            "queries": self.queries,
            "cache": self.cache,
            "timings": self.timings,
        }

    def dumps(self, indent: int | None = None) -> str:
        return json.dumps(self.as_dict(), indent=indent)
