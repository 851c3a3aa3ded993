"""Synthetic datasets generated on the card: the port of
``shine_tpu/io/device_synth.py``.

``device_synthetic_dataset`` and ``device_synthetic_ext_dataset`` generate
the mixture-of-Gaussians family chunk by chunk, each chunk a pure function
of its own key (``split(key, n // rchunk)``): the first keeps the f32 base
on the card, the second streams it into FastFlat's packed table with the
exact ground truth folded on the way, and can regenerate a chunk by index.

Row ``id`` of a row-keyed base derives from ``fold_in(key, id)`` alone
(``regen_rows``), so any row can be regenerated exactly, in any order and
on any device, and the f32 base never has to exist as one array. The
datasets stream the rows in chunks: each chunk folds into an exact f32
running top-``gt_k`` for the queries and is packed into the score table
(the split tables, or FastFlat's packed bf16 table), then dropped. The
result carries ``row_source`` = (key, centers), with which the indexes
re-rank exactly from regenerated rows (``ops/distance.py:
regen_rerank_topk``) at the table's memory alone. The keys, the cluster
draws and the queries' anchors are the JAX package's from the same seed
(``ops/threefry.py``), so both packages build the same data.

With ``mesh=`` (``parallel/mesh.py``) the row-keyed datasets ingest row-sharded:
shard s streams rows [s * n / S, (s + 1) * n / S) on its own device and folds
their ground truth; the shards' top-``gt_k`` lanes then meet in one
``all_gather`` and a (dist, id) top-k. The tables come back as per-shard lists
that equal the single-device tables cut in S, bit for bit, and so does the
ground truth: a row depends on its global id alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.device import resolve_device
from shine_tpu_torch.ops.regen import regen_rows
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.ops.beam import dist_id_key
from shine_tpu_torch.ops.distance import matmul_nt, squared_norms
from shine_tpu_torch.ops.scan import QUANTUM, ext_width
from shine_tpu_torch.ops.scan_split import SPLIT_QUANTUM, pack_split_device

@dataclass
class DeviceDataset:
    base_dev: torch.Tensor  # (n, d) f32 on the card
    queries: np.ndarray  # (q, d) f32
    ground_truth: np.ndarray | None  # (q, gt_k) int32
    metric: str = "l2"
    name: str = "device-synth"

    @property
    def n(self) -> int:
        return self.base_dev.shape[0]


@dataclass
class DeviceExtDataset:
    ext_dev: torch.Tensor | list  # (n, dp) bf16 packed score table; per shard with mesh=
    n: int
    queries: np.ndarray  # (q, d) f32
    ground_truth: np.ndarray | None  # (q, gt_k) int32
    metric: str = "l2"
    name: str = "device-synth-ext"
    regen: object = None  # chunk index -> (rchunk, d) f32 rows of that chunk
    rchunk: int = 0
    row_source: object = None  # (key, centers): any row regenerated by id


@dataclass
class DeviceSplitDataset:
    comp_dev: torch.Tensor | list  # (n, dpc) bf16 or int8; per shard with mesh=
    aux_dev: torch.Tensor | list  # (2, n) f32: nrm, scl; per shard with mesh=
    n: int
    queries: np.ndarray
    ground_truth: np.ndarray | None
    metric: str = "l2"
    name: str = "device-split"
    row_source: object = None  # (key, centers): exact per-id regen


def _pack_ext_rows(x: torch.Tensor, sq: torch.Tensor, dp: int,
                   metric_l2: bool) -> torch.Tensor:
    """One chunk of f32 rows -> packed bf16 table rows (``ops/scan.py``):
    [2x | c0 | -||x||^2 - c0] under L2, c0 the bf16 rounding of -||x||^2;
    [x | 0 | 0] under IP."""
    m, d = x.shape
    row = torch.zeros((m, dp), dtype=torch.float32, device=x.device)
    if metric_l2:
        c0 = (-sq).to(torch.bfloat16).to(torch.float32)
        row[:, :d] = 2.0 * x
        row[:, d] = c0
        row[:, d + 1] = -sq - c0
    else:
        row[:, :d] = x
    return row.to(torch.bfloat16)


def _tile_rows(n: int, rchunk: int, quantum: int, shards: int = 1
               ) -> tuple[int, int]:
    """n rounded up to ``quantum * shards``, and the chunk halved until it
    divides a shard's rows, as the JAX package sizes them."""
    n = -(-n // (quantum * shards)) * quantum * shards
    while n % (rchunk * shards) or rchunk > n // shards:
        rchunk //= 2
        if rchunk == 0:
            raise ValueError(f"n={n} is not tileable over {shards} shards")
    return n, rchunk


def _rowkeyed_recipe(n: int, dim: int, num_queries: int, num_clusters: int,
                     seed: int, metric_l2: bool, dev: torch.device):
    """The JAX package's row-keyed recipe: k0..k3 = split(PRNGKey(seed), 4),
    centres normal(k0) * 4, query anchors regenerated at randint(k2) ids,
    queries = anchors + 0.3 * normal(k3) (unit-normalised under IP).
    Returns (k1, centers, queries (q, d) f32 on ``dev``)."""
    k0, k1, k2, k3 = tf.split(tf.prng_key(seed), 4)
    centers = (tf.normal(k0, (num_clusters, dim)) * 4.0).to(dev)
    qidx = tf.randint(k2, (num_queries,), 0, n)
    anchors = regen_rows(k1, centers, qidx, normalize=not metric_l2)
    queries = anchors + 0.3 * tf.normal(k3, (num_queries, dim)).to(dev)
    if not metric_l2:
        queries = _unit_rows(queries)
    return k1, centers, queries


def _fold_topk(gt_key, gt_i, dd: torch.Tensor, ids: torch.Tensor, gt_k: int):
    """Merge one chunk's (q, m) distances into the running top-gt_k, in
    (dist, id) order."""
    ids = ids.expand(dd.shape[0], -1)
    all_key = torch.cat([gt_key, dist_id_key(dd, ids)], 1)
    all_i = torch.cat([gt_i, ids], 1)
    gt_key, sel = torch.topk(all_key, min(gt_k, all_key.shape[1]), dim=1,
                             largest=False)
    return gt_key, torch.gather(all_i, 1, sel)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-30)


def _chunk_rows(kc: torch.Tensor, centers: torch.Tensor, rchunk: int,
                normalize: bool) -> torch.Tensor:
    """One chunk of the chunk-keyed family: ka, kn = split(kc), rchunk
    cluster draws randint(ka) and centers[a] + normal(kn, (rchunk, d)),
    on the device of ``centers`` (plain torch: the JAX package's
    ``_gen_base`` body)."""
    nc, d = centers.shape
    ka, kn = tf.split(kc.to(centers.device), 2)
    x = centers[tf.randint(ka, (rchunk,), 0, nc)] + tf.normal(kn, (rchunk, d))
    return _unit_rows(x) if normalize else x


def _rowkeyed(k1, centers, metric_l2: bool):
    """Rows [lo, lo + m) of a row-keyed base."""
    def rows_at(lo: int, m: int) -> torch.Tensor:
        ids = torch.arange(lo, lo + m, dtype=torch.int64, device=centers.device)
        return regen_rows(k1, centers, ids, normalize=not metric_l2)
    return rows_at


def _ingest_span(lo0: int, n: int, rchunk: int, rows_at, queries, metric_l2: bool,
                 gt_k: int, pack) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream rows [lo0, lo0 + n) in chunks of ``rchunk`` (``rows_at(lo, m)``):
    fold each into the exact f32 top-gt_k of the queries and hand it to
    ``pack(lo, x, sq)``. Returns the fold's (dist, id) keys and ids."""
    dev = queries.device
    qn = squared_norms(queries)[:, None]
    gt_key = torch.empty((queries.shape[0], 0), dtype=torch.int64, device=dev)
    gt_i = torch.empty((queries.shape[0], 0), dtype=torch.int64, device=dev)
    for lo in range(lo0, lo0 + n, rchunk):
        ids = torch.arange(lo, lo + rchunk, dtype=torch.int64, device=dev)
        x = rows_at(lo, rchunk)
        sq = squared_norms(x)
        dots = matmul_nt(queries, x)
        dd = qn - 2.0 * dots + sq[None, :] if metric_l2 else 1.0 - dots
        gt_key, gt_i = _fold_topk(gt_key, gt_i, dd, ids, gt_k)
        pack(lo, x, sq)
    return gt_key, gt_i


def _ingest(n: int, rchunk: int, rows_at, queries, metric_l2: bool,
            gt_k: int, pack) -> np.ndarray:
    """``_ingest_span`` over rows [0, n): the ground truth (q, gt_k) int32."""
    return _ingest_span(0, n, rchunk, rows_at, queries, metric_l2, gt_k,
                        pack)[1].to(torch.int32).cpu().numpy()


def _ingest_sharded(mesh, n: int, rchunk: int, k1, centers, queries,
                    metric_l2: bool, gt_k: int, pack_shard) -> np.ndarray:
    """Shard s streams its rows [s * n / S, (s + 1) * n / S) on its device,
    handing each chunk to ``pack_shard(s, lo - s * n / S, x, sq)``; the
    shards' folds meet in one all_gather and a (dist, id) top-gt_k, which
    is the single stream's fold. Returns the ground truth (q, gt_k) int32."""
    S = mesh.size
    n_loc = n // S
    cents, qs = mesh.replicate(centers), mesh.replicate(queries)
    keys, ids = [], []
    for s in range(S):
        rows_at = _rowkeyed(k1, cents[s], metric_l2)
        key_s, i_s = _ingest_span(
            s * n_loc, n_loc, rchunk, rows_at, qs[s], metric_l2, gt_k,
            lambda lo, x, sq, s=s: pack_shard(s, lo - s * n_loc, x, sq))
        keys.append(key_s)
        ids.append(i_s)
    nq = queries.shape[0]
    all_key = mesh.all_gather(keys)[0].reshape(S, nq, -1).transpose(0, 1).reshape(nq, -1)
    all_i = mesh.all_gather(ids)[0].reshape(S, nq, -1).transpose(0, 1).reshape(nq, -1)
    sel = torch.topk(all_key, min(gt_k, all_key.shape[1]), dim=1, largest=False)[1]
    return torch.gather(all_i, 1, sel).to(torch.int32).cpu().numpy()


def device_rowkeyed_split_dataset(
    n: int = 40_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    comp_dtype: str = "int8",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 131_072,
    mesh=None,
    device: torch.device | str | None = None,
) -> DeviceSplitDataset:
    """Row-keyed streaming ingestion into the split tables (136 bytes a
    row in int8, 256 in bf16, at d=128), with the exact f32 ground truth
    folded during the stream, on ``device`` (the CUDA card unless another
    is given). n is rounded up to SPLIT_QUANTUM rows, all of them real.
    With ``mesh`` (a ``ShardMesh``; ``device`` is then its first shard's)
    n is rounded up to SPLIT_QUANTUM * S rows, each shard ingests its row
    range on its device, and ``comp_dev`` and ``aux_dev`` are per-shard
    lists, (n / S, dpc) and (2, n / S). The JAX package's
    ``device_rowkeyed_split_dataset``."""
    S = mesh.size if mesh is not None else 1
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    n, rchunk = _tile_rows(n, rchunk, SPLIT_QUANTUM, S)
    mid = metric_id(metric)
    metric_l2 = mid == METRIC_L2
    k1, centers, queries = _rowkeyed_recipe(n, dim, num_queries, num_clusters,
                                            seed, metric_l2, dev)
    n_loc = n // S
    comps: list = [None] * S
    auxs: list = [None] * S

    def pack_shard(s, lo, x, sq):
        comp_c, aux_c = pack_split_device(x, mid, comp_dtype=comp_dtype)
        if comps[s] is None:
            comps[s] = torch.empty((n_loc, comp_c.shape[1]), dtype=comp_c.dtype,
                                   device=x.device)
            auxs[s] = torch.empty((2, n_loc), dtype=torch.float32, device=x.device)
        comps[s][lo:lo + x.shape[0]] = comp_c
        auxs[s][:, lo:lo + x.shape[0]] = aux_c

    if mesh is None:
        gt = _ingest(n, rchunk, _rowkeyed(k1, centers, metric_l2), queries,
                     metric_l2, gt_k, lambda lo, x, sq: pack_shard(0, lo, x, sq))
        comp_dev, aux_dev = comps[0], auxs[0]
    else:
        gt = _ingest_sharded(mesh, n, rchunk, k1, centers, queries, metric_l2, gt_k,
                             pack_shard)
        comp_dev, aux_dev = comps, auxs
    return DeviceSplitDataset(
        comp_dev=comp_dev, aux_dev=aux_dev, n=n,
        queries=queries.cpu().numpy(), ground_truth=gt, metric=metric,
        name=f"device-rowkeyed-split-{n}x{dim}-{comp_dtype}",
        row_source=(k1, centers))


def device_rowkeyed_ext_dataset(
    n: int = 20_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 131_072,
    mesh=None,
    device: torch.device | str | None = None,
) -> DeviceExtDataset:
    """Row-keyed streaming ingestion into FastFlat's packed bf16 table (the
    f32 base is never resident), with the exact f32 ground truth folded
    during the stream, on ``device`` (the CUDA card unless another is
    given). n is rounded up to the table's 4096-row quantum. The table is
    the port's width (``ops/scan.py:ext_width``); its first d+2 columns are
    the JAX package's. With ``mesh`` (a ``ShardMesh``; ``device`` is then
    its first shard's) n is rounded up to 4096 * S rows, each shard ingests
    its row range on its device, and ``ext_dev`` is a per-shard list of
    (n / S, dp) tables. The JAX package's ``device_rowkeyed_ext_dataset``."""
    S = mesh.size if mesh is not None else 1
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    n, rchunk = _tile_rows(n, rchunk, QUANTUM, S)
    metric_l2 = metric_id(metric) == METRIC_L2
    dp = ext_width(dim)
    k1, centers, queries = _rowkeyed_recipe(n, dim, num_queries, num_clusters,
                                            seed, metric_l2, dev)
    n_loc = n // S
    exts = [torch.empty((n_loc, dp), dtype=torch.bfloat16, device=d)
            for d in (mesh.devices if mesh is not None else [dev])]

    def pack_shard(s, lo, x, sq):
        exts[s][lo:lo + x.shape[0]] = _pack_ext_rows(x, sq, dp, metric_l2)

    rows_at = _rowkeyed(k1, centers, metric_l2)
    if mesh is None:
        gt = _ingest(n, rchunk, rows_at, queries, metric_l2, gt_k,
                     lambda lo, x, sq: pack_shard(0, lo, x, sq))
    else:
        gt = _ingest_sharded(mesh, n, rchunk, k1, centers, queries, metric_l2, gt_k,
                             pack_shard)
    return DeviceExtDataset(
        ext_dev=exts[0] if mesh is None else exts, n=n,
        queries=queries.cpu().numpy(), ground_truth=gt,
        metric=metric, name=f"device-rowkeyed-{n}x{dim}",
        regen=lambda c: rows_at(c * rchunk, rchunk), rchunk=rchunk,
        row_source=(k1, centers))


def _recipe_keys(seed: int, num_clusters: int, dim: int, dev: torch.device):
    """k0..k3 = split(PRNGKey(seed), 4) and the centres normal(k0) * 4."""
    k0, k1, k2, k3 = tf.split(tf.prng_key(seed), 4)
    return (tf.normal(k0, (num_clusters, dim)) * 4.0).to(dev), k1, k2, k3


def device_synthetic_dataset(
    n: int = 10_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    compute_gt: bool = True,
    rchunk: int = 65_536,
    device: torch.device | str | None = None,
) -> DeviceDataset:
    """The mixture-of-Gaussians base generated on ``device`` (the CUDA card
    unless another is given) in chunks of ``rchunk`` rows, each from its own
    key; queries near base rows; the exact f32 ground truth on the same
    device (``FlatIndex``, f32 throughout). n is rounded up to a multiple of
    4096. The JAX package's ``device_synthetic_dataset``."""
    dev = resolve_device(device)
    n, rchunk = _tile_rows(n, rchunk, QUANTUM)
    normalize = metric_id(metric) != METRIC_L2
    centers, k1, k2, k3 = _recipe_keys(seed, num_clusters, dim, dev)
    keys = tf.split(k1, n // rchunk)
    base = torch.empty((n, dim), dtype=torch.float32, device=dev)
    for c in range(n // rchunk):
        base[c * rchunk:(c + 1) * rchunk] = _chunk_rows(keys[c], centers, rchunk, normalize)
    qidx = tf.randint(k2, (num_queries,), 0, n).to(dev)
    queries = base[qidx] + 0.3 * tf.normal(k3, (num_queries, dim)).to(dev)
    if normalize:
        queries = _unit_rows(queries)
    queries_np = queries.cpu().numpy()
    gt = None
    if compute_gt:
        from shine_tpu_torch.models.flat import FlatIndex

        flat = FlatIndex.from_device(base, metric, with_bf16=False)
        gt, _ = flat.search(queries_np, gt_k, use_bf16=False)
        del flat
    return DeviceDataset(base_dev=base, queries=queries_np, ground_truth=gt,
                         metric=metric, name=f"device-synth-{n}x{dim}")


def device_synthetic_ext_dataset(
    n: int = 20_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 262_144,
    device: torch.device | str | None = None,
) -> DeviceExtDataset:
    """The chunk-keyed base streamed into FastFlat's packed bf16 table on
    ``device`` (the CUDA card unless another is given), the f32 base never
    resident: each chunk folds into the exact running ground truth and is
    packed, then dropped. The queries sit near rows of chunk 0. ``regen(c)``
    regenerates chunk c. The JAX package's ``device_synthetic_ext_dataset``."""
    dev = resolve_device(device)
    n, rchunk = _tile_rows(n, rchunk, QUANTUM)
    metric_l2 = metric_id(metric) == METRIC_L2
    dp = ext_width(dim)
    centers, k1, k2, k3 = _recipe_keys(seed, num_clusters, dim, dev)
    keys = tf.split(k1, n // rchunk)

    def chunk(c: int) -> torch.Tensor:
        return _chunk_rows(keys[c], centers, rchunk, not metric_l2)

    qidx = tf.randint(k2, (num_queries,), 0, rchunk).to(dev)
    queries = chunk(0)[qidx] + 0.3 * tf.normal(k3, (num_queries, dim)).to(dev)
    if not metric_l2:
        queries = _unit_rows(queries)
    ext = torch.empty((n, dp), dtype=torch.bfloat16, device=dev)

    def pack(lo, x, sq):
        ext[lo:lo + x.shape[0]] = _pack_ext_rows(x, sq, dp, metric_l2)

    gt = _ingest(n, rchunk, lambda lo, m: chunk(lo // rchunk), queries, metric_l2,
                 gt_k, pack)
    return DeviceExtDataset(
        ext_dev=ext, n=n, queries=queries.cpu().numpy(), ground_truth=gt,
        metric=metric, name=f"device-synth-ext-{n}x{dim}", regen=chunk,
        rchunk=rchunk)


def streaming_eps_recall(ds: DeviceExtDataset, found_ids: np.ndarray, k: int, *,
                         rtol: float = 1e-4) -> float:
    """Distance-tolerance recall of a streamed ext dataset: exact f32
    distances from the chunks the found and true ids live in, regenerated
    with ``ds.regen`` (the base never existed as one array). The share of
    found rows within (1 + rtol) of the true k-th distance."""
    if ds.regen is None or not ds.rchunk:
        raise ValueError("the dataset carries no chunk regenerator")
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(ds.ground_truth)[:, :k]
    dev = ds.row_source[1].device if ds.row_source is not None else ds.ext_dev.device
    qd = torch.from_numpy(np.ascontiguousarray(ds.queries, np.float32)).to(dev)

    def exact(ids: np.ndarray) -> np.ndarray:
        out = np.full(ids.shape, np.inf, np.float32)
        for c in np.unique(ids[ids >= 0] // ds.rchunk):
            sel = (ids >= 0) & (ids // ds.rchunk == c)
            v = ds.regen(int(c))[torch.from_numpy(np.where(sel, ids % ds.rchunk, 0)).to(dev)]
            if metric_id(ds.metric) == METRIC_L2:
                dd = ((qd[:, None, :] - v) ** 2).sum(dim=-1)
            else:
                dd = 1.0 - torch.einsum("qd,qkd->qk", qd, v)
            out = np.where(sel, dd.cpu().numpy(), out)
        return out

    df, dg = exact(found), exact(gt)
    thresh = np.sort(dg, axis=1)[:, k - 1] * (1.0 + rtol) + 1e-12
    return float((df <= thresh[:, None]).mean())


def rowkeyed_scorer_crosscheck(row_source, queries, *, n_sub: int = 524_288,
                               n_eval: int = 128, metric: str | int = "l2",
                               rchunk: int = 65_536) -> float:
    """The exact scorer certified against numpy: regenerate the first
    ``n_sub`` rows on the device of the source's centres, copy them to the
    host, and compare the device's exact top-10 (``FlatIndex``, f32
    throughout) with ``numpy_subset_gt`` for the first ``n_eval`` queries.
    Returns their overlap: 1.0 certifies the device's precision settings
    (a TF32 product reads ~0.93 here)."""
    from shine_tpu_torch.io.recall import numpy_subset_gt, recall_at_k
    from shine_tpu_torch.models.flat import FlatIndex

    m = metric_id(metric)
    key, centers = row_source
    dev = centers.device
    sub = np.concatenate([
        regen_rows(key, centers, torch.arange(lo, min(lo + rchunk, n_sub),
                                              dtype=torch.int64, device=dev),
                   normalize=m != METRIC_L2).cpu().numpy()
        for lo in range(0, n_sub, rchunk)])
    q = np.asarray(queries)[:n_eval].astype(np.float32)
    dev_ids, _ = FlatIndex(sub, metric=m, device=dev).search(q, 10, use_bf16=False)
    return float(recall_at_k(dev_ids, numpy_subset_gt(q, sub, 10, metric=m), 10))
