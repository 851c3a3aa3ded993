"""Online (incremental) index, runtime inserts into a live graph: the port of
``shine_tpu/models/dynamic.py``.

The reference streams vectors into its shared remote graph while it serves
queries (``src/hnsw/hnsw.hh:40-251``). Here the insert
rounds of ``models/build.py`` run on one device: capacity is allocated up
front with zero placeholder rows, levels are drawn for the whole capacity,
and ``add`` appends rows and runs deterministic rounds. ``searcher``
serves a snapshot of the inserted prefix (snapshot isolation, in place of
the reference's lock-free readers that tolerate torn lists).

With ``mesh=`` (a ``ShardMesh``) the rounds run data-parallel over its
shards (``models/build.py:make_sharded_insert_round``): the reference's
distributed concurrent inserts as SPMD rounds. Each distinct device of the
mesh holds one copy of the state, and ``searcher`` serves the snapshot from
a row-sharded ``parallel.ShardedIndex``.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, HNSWParams
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.graph.soa import GraphSoA
from shine_tpu_torch.models.build import (
    build_state_to_graph,
    init_build_state,
    insert_round,
    make_sharded_insert_round,
    mesh_device,
    replicate_build_state,
    sharded_upper_batch,
    upper_batch,
)
from shine_tpu_torch.models.hnsw import HNSWIndex
from shine_tpu_torch.ops.distance import squared_norms


class DynamicHNSWIndex:
    """Append-only online index with pre-allocated capacity, on ``device``
    (the CUDA card unless another is given), or over the shards of
    ``mesh`` (``device`` must then be None or its first shard's)."""

    def __init__(
        self,
        dim: int,
        capacity: int,
        params: HNSWParams | None = None,
        *,
        batch_size: int = 512,
        mesh=None,
        device: torch.device | str | None = None,
    ):
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params or HNSWParams()
        self.capacity = capacity
        self.dim = dim
        self.batch_size = batch_size
        # zero placeholder rows; count starts at 1 only once the first real
        # vector arrives (see add())
        placeholder = np.zeros((capacity, dim), np.float32)
        self.st = init_build_state(placeholder, self.params, device=self.device)
        self.st.count = 0
        # one state a distinct device of the mesh; self.st is the first
        self.states = (replicate_build_state(self.st, mesh) if mesh is not None
                       else [self.st])
        self._sharded_runs: dict = {}
        self.count = 0

    def add(self, vectors: np.ndarray) -> None:
        """Insert a batch of vectors; ids are assigned consecutively."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        b, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"vectors have {d} columns, the index {self.dim}")
        if self.count + b > self.capacity:
            raise ValueError(f"capacity exceeded: {self.count} + {b} > "
                             f"{self.capacity}")
        lo = self.count
        start = 1 if lo == 0 else lo
        for st in {id(st): st for st in self.states}.values():
            rows = torch.from_numpy(vectors).to(st.device)
            st.vectors[lo : lo + b] = rows
            if self.params.metric_id == METRIC_L2:
                st.vec_sqnorms[lo : lo + b] = squared_norms(rows)
            if lo == 0:
                # node 0 bootstraps the index (hnsw.hh:56-84)
                st.count, st.entry_point = 1, 0
                st.entry_level = int(st.levels[0])
        # rounds ramp while the graph is small: within a round the inserts
        # cannot see each other, so early rounds stay comparable to the
        # inserted prefix; powers of two, as the JAX package's jit variants
        blo = start
        while blo < lo + b:
            B = min(self.batch_size, max(16, blo))
            B = min(1 << (B - 1).bit_length(), self.batch_size)
            bhi = min(blo + B, lo + b)
            ids = np.full(B, -1, np.int32)
            ids[: bhi - blo] = np.arange(blo, bhi, dtype=np.int32)
            # a multiple of 8, as the JAX package keeps it for its meshes
            B_up = -(-upper_batch(B, self.params.M) // 8) * 8
            if self.mesh is None:
                insert_round(self.st, ids, ef=self.params.ef_construction, frontier=4,
                             max_add=2 * self.params.M, metric=self.params.metric_id,
                             B_up=B_up)
            else:
                self._run_sharded(B, B_up, ids)
            blo = bhi
        self.count = lo + b

    def _run_sharded(self, B: int, B_up: int, ids: np.ndarray) -> None:
        """One round over the mesh, its round function kept per (B,
        B_up_loc) as the JAX package keeps its compiled variants."""
        key = (B, sharded_upper_batch(B, B_up, self.mesh.size))
        run = self._sharded_runs.get(key)
        if run is None:
            run = self._sharded_runs[key] = make_sharded_insert_round(
                self.mesh, ef=self.params.ef_construction, frontier=4,
                max_add=2 * self.params.M, metric=self.params.metric_id,
                B_up_loc=key[1])
        run(self.states, ids)

    def snapshot(self) -> GraphSoA:
        """A consistent point-in-time graph over the inserted prefix."""
        if self.count == 0:
            raise ValueError("empty index")
        return build_state_to_graph(self.st, self.params, n=self.count)

    def searcher(self, **kwargs):
        """An HNSWIndex over the current snapshot, on the index's device
        unless ``device`` is given, or on a mesh a ``parallel.ShardedIndex``
        over the mesh; ``rows=`` and the rest pass through."""
        if self.mesh is not None:
            # imported here, as the JAX package does, so that models and
            # parallel do not import each other at module level
            from shine_tpu_torch.parallel import ShardedIndex

            return ShardedIndex(self.snapshot(), self.mesh, **kwargs)
        kwargs.setdefault("device", self.device)
        return HNSWIndex(self.snapshot(), **kwargs)
