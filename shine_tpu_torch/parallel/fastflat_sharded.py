"""The class-max scans over a row-sharded table: the port of
``shine_tpu/parallel/fastflat_sharded.py``.

Each shard holds an equal row range of the table (FastFlat's packed bf16
table, or the split tables) on its device, runs the class-max scan (K2 or
K3, ``ops/classmax.py``) over its own rows for the whole replicated batch,
selects its best ``kb`` classes and re-ranks them: exactly against its own
f32 rows (``ShardedFastFlatIndex``), from its own bf16 or split rows, or
exactly from rows regenerated by global id with a ``row_source``. The
shards' (B, kb) (dist, global id) lanes then meet in one ``all_gather`` and
a (dist, id) top-k, the only traffic between shards. Global ids are a
shard's local row plus ``s * rows``. A shard's batch is the single card's
``fast_flat_search`` or ``split_flat_search`` given that offset, which
selects the JAX package's sharded re-rank rule (``models/flat.py:_rerank``).

The knobs (``kb``, ``cls``, ``keep2``, the fused select) resolve on a
shard's row count, as in the JAX package: a scan is shard-local. The shards
run one after another in one process (``parallel/mesh.py``); on one card
every kernel launches once a shard a batch.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.models.flat import (
    fast_flat_search,
    kb_auto,
    keep2_auto,
    split_flat_search,
)
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table
from shine_tpu_torch.ops.scan_split import SPLIT_QUANTUM, pack_split_tables
from shine_tpu_torch.parallel.flat_sharded import merge_topk
from shine_tpu_torch.parallel.mesh import ShardMesh


def shard_rows(t: torch.Tensor | list, mesh: ShardMesh, dim: int = 0) -> list:
    """A global table cut into the mesh's shards along ``dim`` (each its own
    contiguous tensor on its shard's device), or per-shard parts placed."""
    if isinstance(t, (list, tuple)):
        if len(t) != mesh.size:
            raise ValueError(f"{len(t)} parts for {mesh.size} shards")
        return mesh.put([p.contiguous() for p in t])
    if dim == 0:
        return mesh.scatter(t)
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    per = n // mesh.size
    return mesh.put([t.narrow(dim, s * per, per).contiguous()
                     for s in range(mesh.size)])


def _row_sources(row_source, mesh: ShardMesh):
    """(key, centres) a shard: the centres on each shard's device."""
    if row_source is None:
        return None
    key, centers = row_source
    return [(key, c) for c in mesh.replicate(centers)]


def _shuffled(vectors: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(the host rows in the order of numpy's permutation from ``seed``, as
    the JAX package shuffles them, the permutation: packed id -> id)."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    perm = np.random.default_rng(seed).permutation(v.shape[0]).astype(np.int32)
    return v[perm], perm


class _ShardedScan:
    """What the two sharded scans share: the knob rules, the batch loop,
    dropping the pad rows' ids, undoing the shuffle and the analytic cost.
    A subclass gives ``default_kb`` (the JAX class's), ``_shard_batch``, a
    shard's (dists, global ids) lanes for one replicated batch, and
    ``_table_bytes``."""

    mesh: ShardMesh
    perm: np.ndarray | None
    n: int
    rows: int
    dim: int
    default_kb: int

    def _auto_kb(self, kb: int | None) -> int:
        return self.default_kb if kb is None else kb

    def resolve_knobs(self, k: int, kb: int, cls: int, keep2):
        """The JAX package's sharded rules on a shard's rows: ``_auto_kb``
        (None: the class's default; FastFlat's ``kb_auto`` at kb <= 0), cls 1024 where keep2 would hold
        at 2048 else 2048, keep2 by ``keep2_auto``, kb at least k, the select
        fused at keep2 with kb <= 32 or at kb <= 16: (kb, cls, keep2,
        fused)."""
        kb = self._auto_kb(kb)
        if cls <= 0:
            cls = 1024 if keep2_auto(self.rows, 2048) else 2048
        if keep2 is None:
            keep2 = keep2_auto(self.rows, cls)
        kb = max(kb, k)
        return kb, cls, keep2, (keep2 and kb <= 32) or kb <= 16

    def search(self, queries: np.ndarray, k: int = 10, *, kb: int | None = None,
               batch_size: int = 4096, tq: int = 512, cls: int = 0,
               keep2: bool | None = None,
               prerank: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(ids (nq, k) int32, dists (nq, k) f32) in the caller's id space.
        ``kb`` None takes ``default_kb``; the knobs left at 0/None take
        ``resolve_knobs``' rules; ``prerank`` trims by the scan's scores
        before an exact re-rank; ``tq`` rounds the batch up to a multiple of
        itself."""
        kb, cls, keep2, fused = self.resolve_knobs(k, kb, cls, keep2)
        nq, d = queries.shape
        batch_size = min(batch_size, max(nq, 1))
        batch_size = max(tq, -(-batch_size // tq) * tq)
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            qs = self.mesh.replicate(torch.from_numpy(q))
            parts = [self._shard_batch(s, qs[s], k=k, kb=kb, cls=cls, keep2=keep2,
                                       prerank=prerank, fused_sel=fused)
                     for s in range(self.mesh.size)]
            md, mi = merge_topk(self.mesh, [p[0] for p in parts],
                                [p[1] for p in parts], k)
            out_d[lo:hi] = md[: hi - lo].cpu().numpy()
            out_i[lo:hi] = mi[: hi - lo].cpu().numpy()
        # a shard whose rows are all padding returns pad rows; drop ids >= n
        # before the shuffle's map, which is n long
        out_i = np.where(out_i < self.n, out_i, -1)
        if self.perm is not None:
            out_i = np.where(out_i >= 0, self.perm[np.maximum(out_i, 0)], -1)
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, kb: int | None = None,
                      batch_size: int = 4096) -> dict:
        """The cluster's analytic cost, the JAX package's count: every batch
        streams the whole sharded table; each shard re-ranks kb survivors
        (resolved by ``_auto_kb``); the queries go out to S - 1 shards and
        (B, kb) (dist, id) lanes come back."""
        kb = self._auto_kb(kb)
        S = self.mesh.size
        n_pad = self.rows * S
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * n_pad + nq * kb * S,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * self._table_bytes()
            + nq * kb * S * self.dim * 4,
            "ici_exchange_bytes": nq * self.dim * 4 * (S - 1)
            + nq * kb * 8 * (S - 1),
        }


class ShardedSplitFlatIndex(_ShardedScan):
    """Row-sharded near-exact k-NN on the split tables (bf16 or int8
    components with an f32 norm and scale a row): the capacity layout over
    a mesh. The re-rank reads the shard's split tables, or with a
    ``row_source`` regenerates the rows exactly by global id."""

    default_kb = 32

    def __init__(self, comp_dev, aux_dev, n: int, mesh: ShardMesh,
                 metric: str | int = "l2", *, dim: int | None = None,
                 row_source=None):
        """``comp_dev`` (n_pad, dpc) and ``aux_dev`` (2, n_pad) as global
        tables, cut here into S row ranges, or as per-shard lists (a mesh
        dataset's); n_pad is a multiple of SPLIT_QUANTUM * S."""
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.size
        self.comp = shard_rows(comp_dev, mesh)
        self.aux = shard_rows(aux_dev, mesh, dim=1)
        rows, dpc = self.comp[0].shape
        n_pad = rows * S
        if n_pad % (SPLIT_QUANTUM * S) or n > n_pad:
            raise ValueError(f"the tables need rows % {SPLIT_QUANTUM * S} == 0 "
                             f"and n <= rows, got {n_pad} rows for n={n}")
        if any(tuple(a.shape) != (2, rows) for a in self.aux):
            raise ValueError(f"aux must be (2, {n_pad})")
        self.n, self.rows = n, rows
        self.dim = dim if dim is not None else dpc
        self.row_source = row_source
        self._sources = _row_sources(row_source, mesh)
        self.perm = None  # from_host's shuffle: packed id -> original id

    @classmethod
    def from_host(cls, vectors: np.ndarray, mesh: ShardMesh,
                  metric: str | int = "l2", *, comp_dtype: str = "int8",
                  seed: int = 0) -> "ShardedSplitFlatIndex":
        """Pack host rows into row-sharded split tables: the rows shuffled
        with numpy's permutation from ``seed`` (as the JAX package and
        ``SplitFlatIndex`` do), padded to SPLIT_QUANTUM * S rows, packed on
        the host and cut into the shards, so that no device holds more than
        its shard. Search maps the packed ids back through the
        permutation."""
        v, perm = _shuffled(vectors, seed)
        quantum = SPLIT_QUANTUM * mesh.size
        n_pad = -(-v.shape[0] // quantum) * quantum
        comp, aux = pack_split_tables(v, metric_id(metric), n_pad,
                                      comp_dtype=comp_dtype)
        self = cls(comp, aux, v.shape[0], mesh, metric, dim=v.shape[1])
        self.perm = perm
        return self

    @classmethod
    def from_dataset(cls, ds, mesh: ShardMesh, **kw) -> "ShardedSplitFlatIndex":
        """From ``io/device_synth.device_rowkeyed_split_dataset`` (per-shard
        tables when built with ``mesh=``), re-ranked from its row source."""
        return cls(ds.comp_dev, ds.aux_dev, ds.n, mesh, ds.metric,
                   row_source=ds.row_source, **kw)

    def _shard_batch(self, s, q, *, k, kb, cls, keep2, prerank, fused_sel):
        return split_flat_search(
            self.comp[s], self.aux[s], None, None, q, k=k, kb=kb, cls=cls,
            metric=self.metric, keep2=keep2, n=self.rows, prerank=prerank,
            fused_sel=fused_sel, row_source=None if self._sources is None
            else self._sources[s], offset=s * self.rows)

    def _table_bytes(self) -> int:
        return sum(c.numel() * c.element_size() + a.numel() * a.element_size()
                   for c, a in zip(self.comp, self.aux))


class ShardedFastFlatIndex(_ShardedScan):
    """Row-sharded near-exact k-NN through the class-max scan (K2): each
    shard re-ranks its best classes exactly against its own f32 rows, or,
    built from a table alone (``from_ext``), from its bf16 table rows or
    from rows regenerated by global id with a ``row_source``."""

    default_kb = 0  # kb_auto on a shard's rows

    def _auto_kb(self, kb: int | None) -> int:
        kb = super()._auto_kb(kb)
        return kb if kb > 0 else kb_auto(self.rows, self.dim)

    def __init__(self, vectors: np.ndarray, mesh: ShardMesh,
                 metric: str | int = "l2", *, seed: int = 0):
        """Shuffle the host rows with numpy's permutation from ``seed`` (the
        JAX package's), pad to 4096 * S rows (pad rows: zero, norm +inf),
        pack on the host and cut the table, rows and norms into the
        shards, so that no device holds more than its shard."""
        self.metric = metric_id(metric)
        self.mesh = mesh
        v, self.perm = _shuffled(vectors, seed)
        n, d = v.shape
        quantum = QUANTUM * mesh.size
        n_pad = -(-n // quantum) * quantum
        ext = pack_ext_table(v, self.metric, n_pad)
        vpad = np.zeros((n_pad, d), np.float32)
        vpad[:n] = v
        sq = ((vpad * vpad).sum(-1) if self.metric == METRIC_L2
              else np.zeros(n_pad, np.float32))
        sq[n:] = np.inf
        self._place(ext, torch.from_numpy(vpad), torch.from_numpy(sq.astype(np.float32)))
        self.n, self.dim = n, d
        self.row_source = self._sources = None

    def _place(self, ext, vectors, sqnorms) -> None:
        self.ext = shard_rows(ext, self.mesh)
        self.vectors = None if vectors is None else shard_rows(vectors, self.mesh)
        self.sqnorms = None if sqnorms is None else shard_rows(sqnorms, self.mesh)
        self.rows = self.ext[0].shape[0]
        n_pad = self.rows * self.mesh.size
        if n_pad % (QUANTUM * self.mesh.size):
            raise ValueError(f"the table needs rows % {QUANTUM * self.mesh.size} == 0")

    @classmethod
    def from_ext(cls, ext_dev, n: int, mesh: ShardMesh, metric: str | int = "l2",
                 *, dim: int | None = None, row_source=None) -> "ShardedFastFlatIndex":
        """Sharded capacity mode: the packed bf16 table alone (global, or a
        mesh dataset's per-shard list), no f32 rows. Each shard re-ranks from
        its table rows, or exactly from rows regenerated by global id with
        ``row_source`` = (key, centers) (``io/device_synth.py``). ``dim`` is
        the true dimension; it drives ``kb_auto``."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.mesh = mesh
        parts = ext_dev if isinstance(ext_dev, (list, tuple)) else None
        self._place([p.to(torch.bfloat16) for p in parts] if parts is not None
                    else ext_dev.to(torch.bfloat16), None, None)
        if n > self.rows * mesh.size:
            raise ValueError(f"n={n} exceeds the table's rows")
        dp = self.ext[0].shape[1]
        if dim is None:
            dim = dp - 2 if self.metric == METRIC_L2 else dp
        self.n, self.dim = n, dim
        self.perm = None
        self.row_source = row_source
        self._sources = _row_sources(row_source, mesh)
        return self

    def _shard_batch(self, s, q, *, k, kb, cls, keep2, prerank, fused_sel):
        ext = self.ext[s]
        q_ext = pack_ext_query(q, ext.shape[1]).to(torch.bfloat16)
        resident = self.vectors is not None
        return fast_flat_search(
            ext, self.vectors[s] if resident else None,
            self.sqnorms[s] if resident else None, q_ext, q, k=k, kb=kb,
            tq=q.shape[0], tn=cls, cls=cls, metric=self.metric, keep2=keep2,
            n=self.rows, prerank=prerank, fused_sel=fused_sel,
            row_source=None if self._sources is None else self._sources[s],
            offset=s * self.rows)

    def _table_bytes(self) -> int:
        return sum(e.numel() * 2 for e in self.ext)
