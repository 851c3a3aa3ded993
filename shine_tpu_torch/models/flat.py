"""Brute-force k-NN on one CUDA card (or the CPU): the PyTorch port of
``shine_tpu/models/flat.py``'s ``FlatIndex``, ``FastFlatIndex`` and
``SplitFlatIndex``.

``FlatIndex`` scans every row in chunks with a running top-k (bf16
operands, f32 sums, then an exact f32 re-rank of ``rerank * k``
survivors; or exact f32 throughout). It is plain torch, as the JAX
package left it to XLA.

``FastFlatIndex`` and ``SplitFlatIndex`` are near-exact: a class-max scan
reduces each query's scores to the best row of each of ``cls`` row
classes (and its runner-up with keep2), the best ``kb`` classes are
selected, and their rows are re-ranked exactly in f32. A true neighbour is
lost only when a better one shares its class (~C(k,2)/cls); rows are
shuffled at build so that class membership does not follow id order.
``FastFlatIndex`` scans the packed bf16 table (``ops/scan.py``, the K2
kernel), or with ``blockmax`` through the block-max scan (K5, the best two
rows of each 128-row block, ``ops/blockmax.py``): the route the JAX
package's ``FastFlatIndex`` takes when it interprets on the CPU
(``interpret=True``). ``SplitFlatIndex`` scans the split table, bf16 or
int8 components with an f32 norm and scale a row (``ops/scan_split.py``, the K3 kernel), which
holds a row in 256 (bf16) or 136 (int8) bytes at d=128. Without f32 rows
``SplitFlatIndex`` re-ranks from its own tables. The four scan routes are
those of the JAX package: keep1 or keep2, the select fused into the kernel
or not.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.ops import blockmax as bm
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops.beam import smallest_positions
from shine_tpu_torch.ops.distance import (
    check_precision,
    matmul_nt,
    rerank_topk,
    rerank_topk_ext,
    rerank_topk_split,
    score_trim,
    squared_norms,
)
from shine_tpu_torch.ops.scan import (
    NEG,
    QUANTUM,
    pack_ext_device,
    pack_ext_query,
    pack_ext_table,
)
from shine_tpu_torch.ops.scan_split import (
    COMP_DTYPES,
    SPLIT_QUANTUM,
    pack_split_device,
    pack_split_query,
    pack_split_tables,
    pad_split_tables,
)

CHUNK_QUANTUM = 1024
_ROW_SOURCE_MSG = ("row_source (exact re-rank from regenerated rows) is not "
                   "ported yet: ROADMAP A6")


def _top_by_position(d: torch.Tensor, ids: torch.Tensor, kk: int):
    """The kk smallest of each row of ``d`` with their ``ids``."""
    sel = smallest_positions(d, kk)
    return torch.gather(d, 1, sel), torch.gather(ids, 1, sel)


def flat_search(
    data: dict[str, torch.Tensor | int],
    queries: torch.Tensor,  # (B, d)
    *,
    k: int,
    chunk: int = 65536,
    metric: int = METRIC_L2,
    use_bf16: bool = True,
    rerank: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k: (dists (B, k), ids (B, k)). With ``use_bf16`` the
    scan keeps ``rerank * k`` candidates (bf16 rounding reorders
    near-ties) and an exact f32 re-rank picks the final k."""
    check_precision()
    vectors = data["vectors"]
    q = queries.to(device=vectors.device, dtype=torch.float32)
    B = q.shape[0]
    n_pad = vectors.shape[0]
    chunk = min(chunk, n_pad)
    if chunk % CHUNK_QUANTUM and chunk != n_pad:
        raise ValueError(f"chunk must be a multiple of {CHUNK_QUANTUM}")
    qn = (q * q).sum(dim=-1)
    # bf16 operands with f32 sums: a bf16 product is exact in f32
    qc = q.to(torch.bfloat16).to(torch.float32) if use_bf16 else q
    base = data["vectors_bf16"] if use_bf16 else vectors
    kk = min(max(rerank, 1) * k, n_pad) if use_bf16 else k
    dev = q.device
    bd = torch.full((B, kk), torch.inf, device=dev)
    bi = torch.full((B, kk), -1, dtype=torch.int32, device=dev)
    for off in range(0, n_pad, chunk):
        blk = base[off:off + chunk]
        bsq = data["sqnorms"][off:off + chunk]
        dots = matmul_nt(qc, blk)
        if metric == METRIC_L2:
            dd = qn[:, None] - 2.0 * dots + bsq[None, :]
        else:
            dd = 1.0 - dots
        ids = torch.arange(off, off + blk.shape[0], dtype=torch.int32,
                           device=dev).expand(B, -1)
        # construction padding: rows >= n, and the inf-norm sentinel rows
        ok = (ids < data["n"]) & torch.isfinite(bsq)[None, :]
        dd = torch.where(ok, dd, torch.inf)
        bd, bi = _top_by_position(torch.cat([bd, dd], 1),
                                  torch.cat([bi, ids], 1), kk)
    if use_bf16:  # exact f32 re-rank of the survivors, stable on ties
        safe = bi.clamp_min(0).long()
        cv = vectors[safe]
        dots = torch.einsum("bd,bkd->bk", q, cv)
        if metric == METRIC_L2:
            bd = qn[:, None] - 2.0 * dots + data["sqnorms"][safe]
        else:
            bd = 1.0 - dots
        bd = torch.where(bi >= 0, bd, torch.inf)
        bd, bi = _top_by_position(bd, bi, k)
    return bd, bi


class FlatIndex:
    """Exact k-NN (recall 1.0 by construction) on ``device``, the CUDA
    card unless another is given."""

    def __init__(self, vectors: np.ndarray, metric: str | int = "l2", *,
                 device: torch.device | str | None = None):
        dev = resolve_device(device)
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = v.shape
        n_pad = -(-n // CHUNK_QUANTUM) * CHUNK_QUANTUM
        if n_pad != n:
            v = np.concatenate([v, np.zeros((n_pad - n, dim), np.float32)])
        vj = torch.from_numpy(v).to(dev)
        self.metric = metric_id(metric)
        sq = (squared_norms(vj) if self.metric == METRIC_L2
              else torch.zeros(n_pad, device=dev))
        sq = torch.where(torch.arange(n_pad, device=dev) < n, sq, torch.inf)
        self.data = {"vectors": vj, "vectors_bf16": vj.to(torch.bfloat16),
                     "sqnorms": sq, "n": n}
        self.n, self.dim = n, dim

    def search(self, queries: np.ndarray, k: int = 10, *,
               batch_size: int = 4096, chunk: int = 65536,
               use_bf16: bool = True) -> tuple[np.ndarray, np.ndarray]:
        nq, d = queries.shape
        out_i = np.empty((nq, k), dtype=np.int32)
        out_d = np.empty((nq, k), dtype=np.float32)
        batch_size = min(batch_size, max(nq, 1))
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            dd, ii = flat_search(self.data, torch.from_numpy(q), k=k,
                                 chunk=chunk, metric=self.metric,
                                 use_bf16=use_bf16)
            out_d[lo:hi] = dd[: hi - lo].cpu().numpy()
            out_i[lo:hi] = ii[: hi - lo].cpu().numpy()
        return out_i, out_d


def kb_auto(n_rows: int, dim: int) -> int:
    """The JAX package's measured re-rank margin: classes kept per query
    (64 from 1M rows, 128 at d >= 512, else 32)."""
    if dim >= 512:
        return 128
    return 64 if n_rows >= 1_000_000 else 32


def keep2_auto(n_rows: int, cls: int) -> bool:
    """The JAX package's measured keep2 rule: keep each class's runner-up
    once a class holds ~500 rows or more."""
    return n_rows // max(cls, 1) >= 500


def _candidates(out: tuple, kb_eff: int, fused: bool):
    """(vals, cand) of a scan's planes: a fused scan's are already at its
    top-kb lanes, an unfused scan's are selected here by ``select_lanes``.
    With keep2 (four planes) the runner-ups follow the winners, -1 where a
    runner-up never entered."""
    if not fused:
        vals, sel = cm.select_lanes(out[0], kb_eff)
        out = (vals,) + tuple(torch.gather(o, 1, sel) for o in out[1:])
    if len(out) == 2:
        return out
    v1, cand1, v2, c2 = out
    cand2 = torch.where(v2 > NEG, c2, -1)
    return torch.cat([v1, v2], 1), torch.cat([cand1, cand2], 1)


def _exact_rerank(vals, cand, vectors, sqnorms, q, k, metric, prerank):
    """Trim to ``prerank`` candidates by the scan's scores, then re-rank
    exactly in f32."""
    if prerank and max(prerank, k) < cand.shape[-1]:
        cand = score_trim(vals, cand, max(prerank, k))
    return rerank_topk(vectors, sqnorms, q, cand, k, metric)


def _blockmax_candidates(ext, q_ext, kb: int):
    """(vals, cand) of the block-max route: K5, the ``lax.top_k`` of the
    block maxima over min(kb, N_pad/128) blocks (``top_k``), their best
    rows, then their runner-ups, -1 where a runner-up's score is not above
    NEG (the JAX package's ``fast_flat_search`` under ``interpret``)."""
    m1, a1, m2, a2 = bm.blockmax_scan(ext, q_ext)
    v1, sel = cm.top_k(m1, min(kb, m1.shape[1]))
    v2 = torch.gather(m2, 1, sel)
    cand2 = torch.where(v2 > NEG, torch.gather(a2, 1, sel), -1)
    return (torch.cat([v1, v2], 1),
            torch.cat([torch.gather(a1, 1, sel), cand2], 1))


def fast_flat_search(
    ext, vectors, sqnorms, q_ext, q, *, k, kb, tq, tn, cls, metric,
    keep2=False, n=0, approx_sel=False, prerank=0, fused_sel=False,
    blockmax=False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch: class-max scan, select of kb classes, optional score
    trim, exact re-rank. (dists (B, k), ids (B, k)). ``approx_sel`` takes
    the exact select, as ``approx_max_k`` does off the TPU; an unfused
    select is ``select_lanes``. With ``blockmax`` the block-max route
    (``_blockmax_candidates``) replaces the scan and the select, and
    ``cls``, ``keep2``, ``approx_sel`` and ``fused_sel`` play no part.
    Without f32 rows (``vectors`` None) the re-rank reads the bf16 table
    and ``prerank`` is not applied, as in the JAX package."""
    if blockmax:
        vals, cand = _blockmax_candidates(ext, q_ext, kb)
    else:
        kb_eff = min(kb, cls)
        fused = fused_sel and not approx_sel
        if fused:
            scan = cm.classmax2_topk_scan if keep2 else cm.classmax_topk_scan
            out = scan(ext, q_ext, kb=kb_eff, tq=tq, tn=tn, cls=cls)
        else:
            scan = cm.classmax2_scan if keep2 else cm.classmax_scan
            out = scan(ext, q_ext, tq=tq, tn=tn, cls=cls)
        vals, cand = _candidates(out, kb_eff, fused)
    limit = n or vectors.shape[0]
    cand = torch.where(cand < limit, cand, -1)  # pad rows and empty classes
    if vectors is None:
        return rerank_topk_ext(ext, q, cand, k, metric)
    return _exact_rerank(vals, cand, vectors, sqnorms, q, k, metric, prerank)


def split_flat_search(
    comp, aux, vectors, sqnorms, q, *, k, kb, cls, metric, keep2=False, n=0,
    approx_sel=False, prerank=0, fused_sel=False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch on the split tables (the JAX package's
    ``split_flat_search_at`` and ``_split_flat_batch``): pad the f32
    queries ``q`` (B, d) to the component width, class-max scan (K3),
    select of kb classes, optional score trim, exact re-rank; without f32
    rows the re-rank reads the split tables (``rerank_topk_split``) and
    ``prerank`` is not applied. (dists (B, k), ids (B, k))."""
    q_pad = pack_split_query(q, comp.shape[1])
    kb_eff = min(kb, cls)
    fused = fused_sel and not approx_sel
    if fused:
        out = cm.classmax_topk_scan_split(comp, aux, q_pad, kb=kb_eff, cls=cls,
                                          keep2=keep2)
    else:
        out = cm.classmax_scan_split(comp, aux, q_pad, cls=cls, keep2=keep2)
    vals, cand = _candidates(out, kb_eff, fused)
    cand = torch.where(cand < (n or comp.shape[0]), cand, -1)
    if vectors is None:
        return rerank_topk_split(comp, aux, q, cand, k, metric)
    return _exact_rerank(vals, cand, vectors, sqnorms, q, k, metric, prerank)


class _ClassMaxIndex:
    """What FastFlatIndex and SplitFlatIndex share: staging the queries,
    the batch loop and undoing the shuffle. A subclass gives ``device``,
    ``_resolve_knobs`` and ``_search_batch``."""

    perm: np.ndarray | None
    _perm_dev: torch.Tensor | None

    def preload(self, queries: np.ndarray, *, batch_size: int = 4096):
        """Stage the queries on the device once, zero-padded to a multiple
        of ``batch_size``: (q_dev, nq)."""
        nq, d = queries.shape
        nq_pad = -(-nq // batch_size) * batch_size
        q_all = np.zeros((nq_pad, d), np.float32)
        q_all[:nq] = queries
        return torch.from_numpy(q_all).to(self.device), nq

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        tq: int = 512,
        cls: int = 0,
        preloaded=None,
        with_dists: bool = True,
        keep2: bool | None = None,
        approx_sel: bool = False,
        prerank: int = 0,
        fused_sel: bool | None = None,
        megabatch: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(ids (nq, k) int32, dists (nq, k) f32) as numpy, in the caller's
        id space. ``kb``, ``cls``, ``keep2`` and ``fused_sel`` left at
        0/None take the JAX package's measured auto rules
        (``_resolve_knobs``); ``prerank > 0`` trims to that many candidates
        by the scan's own scores before the re-rank. ``tq`` rounds the
        batch up to a multiple of itself and picks no tiling; ``megabatch``
        is accepted for the JAX signature and changes nothing: the batches
        always run in one host loop."""
        nq = queries.shape[0]
        batch_size = max(tq, -(-min(batch_size, max(nq, 1)) // tq) * tq)
        if preloaded is None:
            preloaded = self.preload(queries, batch_size=batch_size)
        elif preloaded[1] != nq or preloaded[0].shape[0] % batch_size:
            raise ValueError("preloaded queries do not match this call")
        ids, dists = self.search_device(
            preloaded, k, kb=kb, batch_size=batch_size, tq=tq, cls=cls,
            keep2=keep2, approx_sel=approx_sel, prerank=prerank,
            fused_sel=fused_sel, megabatch=megabatch)
        out_i = ids.cpu().numpy()
        out_d = (dists.cpu().numpy() if with_dists
                 else np.zeros((nq, k), np.float32))
        return out_i, out_d

    def search_device(
        self,
        preloaded,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        tq: int = 512,
        cls: int = 0,
        keep2: bool | None = None,
        approx_sel: bool = False,
        prerank: int = 0,
        fused_sel: bool | None = None,
        megabatch: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``search`` on staged queries (``preload``), returning (ids, dists)
        as device tensors with the shuffle undone on the device."""
        q_dev, nq = preloaded
        kb, cls, keep2, fused_sel = self._resolve_knobs(
            kb, cls, keep2, fused_sel, approx_sel)
        nq_pad = q_dev.shape[0]
        if nq_pad % batch_size:
            raise ValueError(f"{nq_pad} staged queries are not a multiple of "
                             f"batch_size={batch_size}")
        parts = [
            self._search_batch(
                q_dev[lo:lo + batch_size].to(torch.float32), k=k, kb=kb,
                tq=tq, cls=cls, keep2=keep2, approx_sel=approx_sel,
                prerank=prerank, fused_sel=fused_sel)
            for lo in range(0, nq_pad, batch_size)
        ]
        all_d = torch.cat([p[0] for p in parts])[:nq]
        all_i = torch.cat([p[1] for p in parts])[:nq]
        if self.perm is not None:
            if self._perm_dev is None:
                self._perm_dev = torch.from_numpy(self.perm).to(self.device)
            all_i = torch.where(
                all_i >= 0, self._perm_dev[all_i.clamp_min(0).long()], -1)
        return all_i, all_d


class FastFlatIndex(_ClassMaxIndex):
    """Near-exact brute force through the class-max scan (K2), or with
    ``blockmax`` through the block-max scan (K5), on ``device``, the CUDA
    card unless another is given.

    The host constructor shuffles rows with numpy's permutation from
    ``seed``, as the JAX package does, so both hold the same table.
    ``blockmax`` is the route the JAX package's index takes under
    ``interpret=True``; ``tn`` picks no tiling."""

    def __init__(
        self,
        vectors: np.ndarray,
        metric: str | int = "l2",
        *,
        tn: int = 1024,
        shuffle: bool = True,
        seed: int = 0,
        blockmax: bool = False,
        device: torch.device | str | None = None,
    ):
        dev = resolve_device(device)
        self.metric = metric_id(metric)
        self.blockmax = blockmax
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        self.perm = None
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(n).astype(np.int32)
            v = v[self.perm]
        n_pad = -(-n // QUANTUM) * QUANTUM
        self.ext = pack_ext_table(v, self.metric, n_pad, device=dev)
        self.vectors = torch.from_numpy(v).to(dev)
        sq = ((v * v).sum(-1) if self.metric == METRIC_L2
              else np.zeros(n, np.float32))
        self.sqnorms = torch.from_numpy(sq.astype(np.float32)).to(dev)
        self.n, self.dim, self.tn = n, d, tn
        self.dp = self.ext.shape[1]
        self._perm_dev = None

    @classmethod
    def from_ext(cls, ext_dev: torch.Tensor, n: int, metric: str | int = "l2",
                 *, dim: int | None = None, row_source=None,
                 blockmax: bool = False) -> "FastFlatIndex":
        """From a packed bf16 table alone: no f32 rows are kept and the
        re-rank reads the table (``rerank_topk_ext``). ``dim`` is the true
        dimension (the table is padded); it drives ``kb_auto``."""
        if row_source is not None:
            raise NotImplementedError(_ROW_SOURCE_MSG)
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.blockmax = blockmax
        n_pad, dp = ext_dev.shape
        if n_pad % QUANTUM or n > n_pad:
            raise ValueError(f"the table needs rows % {QUANTUM} == 0 and n <= rows")
        self.ext = ext_dev.to(torch.bfloat16)
        self.vectors = self.sqnorms = self.perm = self._perm_dev = None
        if dim is None:
            dim = dp - 2 if self.metric == METRIC_L2 else dp
        self.n, self.dim, self.tn, self.dp = n, dim, 1024, dp
        return self

    @classmethod
    def from_device(cls, v_dev: torch.Tensor, metric: str | int = "l2", *,
                    shuffle: bool | None = None, seed: int = 0,
                    blockmax: bool = False) -> "FastFlatIndex":
        """From rows already on a device. The table is padded to a multiple
        of 4096 rows with pad rows (the JAX package asks n to be one). The
        shuffle (on unless ``shuffle=False``: the transient row copy
        fits beside any table that fits the card) is a ``torch.Generator``
        permutation from ``seed``, which is not the JAX package's
        ``jax.random`` one: the two hold the same rows in other orders."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.blockmax = blockmax
        n, d = v_dev.shape
        v = v_dev.to(torch.float32)
        self.perm = self._perm_dev = None
        if shuffle or shuffle is None:
            gen = torch.Generator().manual_seed(seed)
            perm = torch.randperm(n, generator=gen).to(torch.int32)
            v = v[perm.to(v.device).long()]
            self.perm = perm.numpy()
        self.ext = pack_ext_device(v, self.metric)
        self.vectors = v
        self.sqnorms = (squared_norms(v) if self.metric == METRIC_L2
                        else torch.zeros(n, device=v.device))
        self.n, self.dim, self.tn, self.dp = n, d, 1024, self.ext.shape[1]
        return self

    @property
    def device(self) -> torch.device:
        return self.ext.device

    def _resolve_knobs(self, kb, cls, keep2, fused_sel, approx_sel):
        n_pad = int(self.ext.shape[0])
        if kb <= 0:
            kb = kb_auto(n_pad, self.dim)
        if cls <= 0:
            cls = 1024 if keep2_auto(n_pad, 2048) else 2048
        if keep2 is None:
            keep2 = keep2_auto(n_pad, cls)
        if fused_sel is None:
            fused_sel = ((keep2 and kb <= 32) or kb <= 16) and not approx_sel
        return kb, cls, keep2, fused_sel

    def _search_batch(self, qj, *, k, kb, tq, cls, keep2, approx_sel,
                      prerank, fused_sel):
        q_ext = pack_ext_query(qj, self.dp).to(torch.bfloat16)
        return fast_flat_search(
            self.ext, self.vectors, self.sqnorms, q_ext, qj, k=k, kb=kb,
            tq=tq, tn=max(self.tn, cls), cls=cls, metric=self.metric,
            keep2=keep2, n=self.n, approx_sel=approx_sel, prerank=prerank,
            fused_sel=fused_sel, blockmax=self.blockmax)

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 0,
                      batch_size: int = 4096) -> dict:
        """Analytic cost: each batch streams the packed table once through
        the scan; kb survivors per query are re-ranked in f32."""
        n_pad = int(self.ext.shape[0])
        if kb <= 0:
            kb = kb_auto(n_pad, self.dim)
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * n_pad + nq * kb,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * self.ext.numel() * 2
            + nq * kb * self.dim * 4,
            "ici_exchange_bytes": 0,
        }


class SplitFlatIndex(_ClassMaxIndex):
    """Near-exact brute force on the split tables through the K3 scan, on
    ``device``, the CUDA card unless another is given: bf16 or int8
    components (``comp_dtype``) with an f32 norm and scale a row, the exact
    f32 rows and norms kept for the re-rank.

    The host constructor shuffles rows with numpy's permutation from
    ``seed`` and packs in numpy, as the JAX package does, so both hold the
    same tables."""

    def __init__(
        self,
        vectors: np.ndarray,
        metric: str | int = "l2",
        *,
        comp_dtype: str = "bf16",
        shuffle: bool = True,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        dev = resolve_device(device)
        self.metric = metric_id(metric)
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        self.perm = self._perm_dev = None
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(n).astype(np.int32)
            v = v[self.perm]
        n_pad = -(-n // SPLIT_QUANTUM) * SPLIT_QUANTUM
        self.comp, self.aux = pack_split_tables(
            v, self.metric, n_pad, comp_dtype=comp_dtype, device=dev)
        self.vectors = torch.from_numpy(v).to(dev)
        sq = ((v * v).sum(-1) if self.metric == METRIC_L2
              else np.zeros(n, np.float32))
        self.sqnorms = torch.from_numpy(sq.astype(np.float32)).to(dev)
        self.n, self.dim, self.comp_dtype = n, d, comp_dtype

    @classmethod
    def from_device(cls, v_dev: torch.Tensor, metric: str | int = "l2", *,
                    comp_dtype: str = "bf16",
                    keep_base: bool = True) -> "SplitFlatIndex":
        """From rows already on a device, packed there with no shuffle, as
        in the JAX package, and padded to SPLIT_QUANTUM rows (the JAX
        package asks n to be a multiple of 4096). With ``keep_base=False``
        the f32 rows are dropped and the re-rank reads the split tables."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n, d = v_dev.shape
        v = v_dev.to(torch.float32)
        comp, aux = pack_split_device(v, self.metric, comp_dtype=comp_dtype)
        self.comp, self.aux = pad_split_tables(
            comp, aux, -(-n // SPLIT_QUANTUM) * SPLIT_QUANTUM)
        self.vectors = self.sqnorms = None
        if keep_base:
            self.vectors = v
            self.sqnorms = (squared_norms(v) if self.metric == METRIC_L2
                            else torch.zeros(n, device=v.device))
        self.perm = self._perm_dev = None
        self.n, self.dim, self.comp_dtype = n, d, comp_dtype
        return self

    @classmethod
    def from_parts(cls, comp_dev: torch.Tensor, aux_dev: torch.Tensor, n: int,
                   metric: str | int = "l2", *, dim: int | None = None,
                   row_source=None) -> "SplitFlatIndex":
        """From packed split tables alone (``pack_split_device``, padded):
        no f32 rows are kept and the re-rank reads the tables. ``dim`` is
        the true dimension (the table may be wider); it drives ``kb``. The
        rows past n must be pad rows (comp 0, nrm <= NEG), so that none
        can take a class from a real row."""
        if row_source is not None:
            raise NotImplementedError(_ROW_SOURCE_MSG)
        n_pad, dpc = comp_dev.shape
        if n_pad % QUANTUM or n > n_pad:
            raise ValueError(f"the tables need rows % {QUANTUM} == 0 and n <= rows")
        if tuple(aux_dev.shape) != (2, n_pad) or aux_dev.dtype != torch.float32:
            raise ValueError(f"aux must be (2, {n_pad}) f32")
        if comp_dev.dtype not in COMP_DTYPES.values():
            raise TypeError(f"comp must be bf16 or int8, got {comp_dev.dtype}")
        if n < n_pad and (bool(comp_dev[n:].any()) or
                          bool((aux_dev[0, n:] > NEG).any())):
            raise ValueError("rows past n must be pad rows: comp 0, nrm <= NEG")
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.comp, self.aux = comp_dev, aux_dev
        self.vectors = self.sqnorms = self.perm = self._perm_dev = None
        self.n, self.dim = n, dim if dim is not None else dpc
        self.comp_dtype = "int8" if comp_dev.dtype == torch.int8 else "bf16"
        return self

    @property
    def device(self) -> torch.device:
        return self.comp.device

    def _resolve_knobs(self, kb, cls, keep2, fused_sel, approx_sel):
        """The JAX package's rules: kb 32 below d=512, else 128; with an
        exact re-rank and keep2 left to the rule, cls=4096 without keep2
        once keep2_auto(n_pad, 2048) holds, else cls 1024 or 2048 and
        keep2 by keep2_auto; the select fused at keep2 with kb <= 32, or
        at kb <= 16."""
        n_pad = int(self.comp.shape[0])
        if kb <= 0:
            kb = 32 if self.dim < 512 else 128
        if cls <= 0:
            if (self.vectors is not None and keep2 is None
                    and keep2_auto(n_pad, 2048)):
                cls, keep2 = 4096, False
            else:
                cls = 1024 if keep2_auto(n_pad, 2048) else 2048
        if keep2 is None:
            keep2 = keep2_auto(n_pad, cls)
        if fused_sel is None:
            fused_sel = ((keep2 and kb <= 32) or kb <= 16) and not approx_sel
        return kb, cls, keep2, fused_sel

    def _search_batch(self, qj, *, k, kb, tq, cls, keep2, approx_sel,
                      prerank, fused_sel):
        return split_flat_search(
            self.comp, self.aux, self.vectors, self.sqnorms, qj, k=k, kb=kb,
            cls=cls, metric=self.metric, keep2=keep2, n=self.n,
            approx_sel=approx_sel, prerank=prerank, fused_sel=fused_sel)

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 0,
                      batch_size: int = 4096) -> dict:
        """Analytic cost: each batch streams both split tables once
        through the scan; kb survivors per query are re-ranked in f32."""
        if kb <= 0:
            kb = 32 if self.dim < 512 else 128
        n_pad = int(self.comp.shape[0])
        batches = -(-nq // max(batch_size, 1))
        table = (self.comp.numel() * self.comp.element_size()
                 + self.aux.numel() * self.aux.element_size())
        return {
            "distance_computations": nq * n_pad + nq * kb,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table + nq * kb * self.dim * 4,
            "ici_exchange_bytes": 0,
        }
