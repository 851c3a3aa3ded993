"""The port's row-sharded class-max scans (shine_tpu_torch.parallel.
fastflat_sharded) against shine_tpu.parallel.fastflat_sharded: FastFlat
resident and in capacity mode (``from_ext`` with a row source), the split
tables from host rows (``from_host``, int8 and bf16) and from a row-keyed
mesh dataset (``from_dataset``). The JAX side runs on 4 of the 8 virtual CPU
devices of ``tests/conftest.py`` with its interpret kernels; the port on a
CPU mesh of 4 shards, on the JAX index's tables carried over by the
``convert`` functions, so that each search is held apart from each build.

Integer rows (every product and sum exact): ids and distances bit for bit
on FastFlat's exact re-rank; on the split tables ids equal and distances
within rtol 1e-6 (the dequantised re-rank multiplies by a float scale);
the host builds' tables equal. Rows regenerated from a key (normals, a few
ulps apart between packages; ROADMAP C5): ids on >= 99% of slots and
distances within rtol 1e-5 where the ids agree."""

import jax
import numpy as np
import pytest
import torch

from shine_tpu.io import device_synth as jds
from shine_tpu.io import synthetic_dataset
from shine_tpu.parallel import shard_mesh as jax_mesh
from shine_tpu.parallel.fastflat_sharded import ShardedFastFlatIndex as JFast
from shine_tpu.parallel.fastflat_sharded import ShardedSplitFlatIndex as JSplit
from shine_tpu_torch.convert import (
    row_source_from_jax,
    sharded_fastflat_from_jax,
    sharded_splitflat_from_jax,
)
from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.io import device_synth as tds
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops.scan import ext_width
from shine_tpu_torch.ops.scan_split import comp_width
from shine_tpu_torch.parallel import (
    ShardedFastFlatIndex,
    ShardedSplitFlatIndex,
    shard_mesh,
)

S, D = 4, 16
MIN_ID_OVERLAP = 0.99
RTOL, ATOL = 1e-5, 1e-3  # C5 on regenerated rows
SPLIT_RTOL = 1e-6
RECALL_GAP = 0.005


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as its raw bits, so that equality is bitwise."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _int_set(n, nq, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, size=(n, D)).astype(np.float32),
            rng.integers(-8, 9, size=(nq, D)).astype(np.float32))


@pytest.fixture(scope="module")
def ints():
    return _int_set(20_000, 64, 3)


@pytest.fixture(scope="module")
def mesh():
    return shard_mesh(S, device="cpu")


@pytest.fixture(scope="module")
def fast_pair(ints, mesh):
    base, _ = ints
    j = JFast(base, jax_mesh(S), seed=1)
    t = sharded_fastflat_from_jax(
        {"ext": _np(j.ext), "vectors": _np(j.vectors), "sqnorms": _np(j.sqnorms),
         "perm": j.perm}, n=j.n, dim=D, metric="l2", mesh=mesh)
    return j, t


FAST_ROUTES = {
    "auto": {},
    "kb16_fused": {"kb": 16},
    "keep2_fused": {"kb": 32, "keep2": True},
    "keep2_prerank": {"kb": 48, "keep2": True, "prerank": 20},
    "cls1024_tq64": {"cls": 1024, "tq": 64, "batch_size": 100},
}


@pytest.mark.parametrize("route", list(FAST_ROUTES))
def test_fastflat_resident_bit_for_bit(fast_pair, ints, route):
    j, t = fast_pair
    _, q = ints
    kw = {"batch_size": 64, **FAST_ROUTES[route]}
    ji, jd = j.search(q, 10, **kw)
    ti, td = t.search(q, 10, **kw)
    np.testing.assert_array_equal(ti, _np(ji))
    np.testing.assert_array_equal(td.view(np.int32), _np(jd).view(np.int32))
    assert (ti >= 0).all() and ti.max() < j.n


def test_fastflat_host_build_equals_jax_tables(fast_pair, ints, mesh):
    """The port's own build holds the JAX index's tables (its ext table at
    the port's width), shard by shard."""
    j, t = fast_pair
    base, _ = ints
    own = ShardedFastFlatIndex(base, mesh, seed=1)
    np.testing.assert_array_equal(own.perm, j.perm)
    assert own.rows == j.rows == t.rows
    for name in ("ext", "vectors", "sqnorms"):
        for a, b in zip(getattr(own, name), getattr(t, name)):
            assert torch.equal(_bits(a), _bits(b)), name
    assert own.ext[0].shape[1] == ext_width(D)


def test_fastflat_knobs_and_cost_counters(fast_pair):
    """The knobs resolve on a shard's rows; the counts equal the JAX
    package's (the table bytes are each package's own width)."""
    j, t = fast_pair
    assert t.resolve_knobs(10, 0, 0, None) == (32, 2048, False, False)
    jc, tc = j.cost_counters(1000), t.cost_counters(1000)
    for key in ("distance_computations", "scanned_rows", "ici_exchange_bytes"):
        assert tc[key] == jc[key], key
    rerank = 1000 * 32 * S * D * 4
    jrow = 2 * (-(-(D + 2) // 128) * 128)
    assert (tc["hbm_gather_bytes"] - rerank) * jrow == \
        (jc["hbm_gather_bytes"] - rerank) * 2 * ext_width(D)


def test_fastflat_gaussian_within_c5(mesh):
    """Float rows: the JAX build's tables served by both, ids on >= 99% of
    slots, distances within C5's tolerance, recall within 0.005."""
    ds = synthetic_dataset(n=16_384, dim=D, num_queries=64, seed=11)
    j = JFast(ds.base, jax_mesh(S), seed=2)
    t = sharded_fastflat_from_jax(
        {"ext": _np(j.ext), "vectors": _np(j.vectors), "sqnorms": _np(j.sqnorms),
         "perm": j.perm}, n=j.n, dim=D, metric="l2", mesh=mesh)
    ji, jd = (_np(x) for x in j.search(ds.queries, 10, batch_size=64))
    ti, td = t.search(ds.queries, 10, batch_size=64)
    assert (ti == ji).mean() >= MIN_ID_OVERLAP
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=RTOL, atol=ATOL)
    assert abs(recall_at_k(ti, ds.ground_truth, 10)
               - recall_at_k(ji, ds.ground_truth, 10)) <= RECALL_GAP


def test_fastflat_capacity_row_source(mesh):
    """from_ext: the JAX mesh dataset's ext table and row source, the exact
    regen re-rank by global id on both sides."""
    ds = jds.device_rowkeyed_ext_dataset(n=65_536, dim=D, num_queries=48, seed=5,
                                         rchunk=4096, num_clusters=16,
                                         mesh=jax_mesh(S))
    j = JFast.from_ext(ds.ext_dev, ds.n, jax_mesh(S), dim=D, row_source=ds.row_source)
    rs = row_source_from_jax(_np(ds.row_source[0]), _np(ds.row_source[1]), device="cpu")
    t = sharded_fastflat_from_jax({"ext": _np(ds.ext_dev)}, n=ds.n, dim=D,
                                  metric="l2", mesh=mesh, row_source=rs)
    assert t.vectors is None and t.row_source is not None
    for kw in ({"kb": 24}, {"kb": 32, "prerank": 16}):
        ji, jd = (_np(x) for x in j.search(ds.queries, 10, tq=64, batch_size=64, **kw))
        ti, td = t.search(ds.queries, 10, tq=64, batch_size=64, **kw)
        assert (ti == ji).mean() >= MIN_ID_OVERLAP
        same = ti == ji
        np.testing.assert_allclose(td[same], jd[same], rtol=RTOL, atol=ATOL)
    assert recall_at_k(ti, ds.ground_truth, 10) >= 0.9
    # without the row source the re-rank reads the bf16 table, as in JAX
    plain = ShardedFastFlatIndex.from_ext(t.ext, t.n, mesh, dim=D)
    jplain = JFast.from_ext(ds.ext_dev, ds.n, jax_mesh(S), dim=D)
    pi, _ = plain.search(ds.queries, 10, kb=24, tq=64, batch_size=64)
    jpi, _ = jplain.search(ds.queries, 10, kb=24, tq=64, batch_size=64)
    assert (pi == _np(jpi)).mean() >= MIN_ID_OVERLAP


@pytest.fixture(scope="module")
def split_pairs(ints, mesh):
    base, _ = ints
    out = {}
    for comp_dtype in ("int8", "bf16"):
        j = JSplit.from_host(base, jax_mesh(S), comp_dtype=comp_dtype, seed=13)
        t = sharded_splitflat_from_jax(
            {"comp": _np(j.comp), "aux": _np(j.aux), "perm": j.perm}, n=j.n, dim=D,
            metric="l2", mesh=mesh)
        out[comp_dtype] = (j, t)
    return out


SPLIT_ROUTES = {
    "auto": {},
    "kb16_fused": {"kb": 16},
    "keep2_fused": {"kb": 32, "keep2": True},
    "keep2_kb48": {"kb": 48, "keep2": True, "cls": 1024},
}


@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("route", list(SPLIT_ROUTES))
def test_split_from_host_against_jax(split_pairs, ints, comp_dtype, route):
    j, t = split_pairs[comp_dtype]
    _, q = ints
    kw = {"batch_size": 64, **SPLIT_ROUTES[route]}
    ji, jd = j.search(q, 10, **kw)
    ti, td = t.search(q, 10, **kw)
    np.testing.assert_array_equal(ti, _np(ji))
    np.testing.assert_allclose(td, _np(jd), rtol=SPLIT_RTOL, atol=1e-4)
    assert ti.max() < j.n and (ti >= -1).all()


@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
def test_split_from_host_tables_equal_jax(split_pairs, ints, mesh, comp_dtype):
    """from_host(seed) shuffles and packs as the JAX package does: the
    tables equal the JAX index's at the port's width, shard by shard, and
    the cost counters agree but for each package's table width."""
    j, t = split_pairs[comp_dtype]
    base, _ = ints
    own = ShardedSplitFlatIndex.from_host(base, mesh, comp_dtype=comp_dtype, seed=13)
    np.testing.assert_array_equal(own.perm, j.perm)
    for a, b in zip(own.comp, t.comp):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(own.aux, t.aux):
        assert torch.equal(a, b)
    assert own.comp[0].shape[1] == comp_width(D)
    jc, tc = j.cost_counters(1000), own.cost_counters(1000)
    for key in ("distance_computations", "scanned_rows", "ici_exchange_bytes"):
        assert tc[key] == jc[key], key


def test_split_from_dataset_against_jax(mesh):
    """from_dataset on the JAX mesh dataset's tables and row source: the
    exact regen re-rank on both sides, with and without the prerank trim."""
    ds = jds.device_rowkeyed_split_dataset(n=65_536, dim=D, num_queries=48, seed=5,
                                           rchunk=4096, comp_dtype="int8",
                                           num_clusters=16, mesh=jax_mesh(S))
    j = JSplit.from_dataset(ds, jax_mesh(S), dim=D)
    rs = row_source_from_jax(_np(ds.row_source[0]), _np(ds.row_source[1]), device="cpu")
    t = sharded_splitflat_from_jax({"comp": _np(ds.comp_dev), "aux": _np(ds.aux_dev)},
                                   n=ds.n, dim=D, metric="l2", mesh=mesh, row_source=rs)
    for kw in ({"kb": 24}, {"kb": 32, "prerank": 16}):
        ji, jd = (_np(x) for x in j.search(ds.queries, 10, tq=64, batch_size=64, **kw))
        ti, td = t.search(ds.queries, 10, tq=64, batch_size=64, **kw)
        assert (ti == ji).mean() >= MIN_ID_OVERLAP
        same = ti == ji
        np.testing.assert_allclose(td[same], jd[same], rtol=RTOL, atol=ATOL)
        assert np.all(np.diff(td, axis=1) >= 0)
    assert recall_at_k(ti, ds.ground_truth, 10) >= 0.9


def test_split_from_port_mesh_dataset(mesh):
    """The port's own mesh dataset served by from_dataset: the shards take
    the dataset's tables as they are, recall >= 0.9, and on the CPU the
    twins run, so no launch is counted."""
    ds = tds.device_rowkeyed_split_dataset(n=65_536, dim=D, num_queries=48, seed=5,
                                           rchunk=4096, comp_dtype="int8",
                                           num_clusters=16, mesh=mesh)
    idx = ShardedSplitFlatIndex.from_dataset(ds, mesh, dim=D)
    assert all(a is b for a, b in zip(idx.comp, ds.comp_dev))
    before = cm.classmax_scan_split.launches
    ids, dd = idx.search(ds.queries, 10, kb=24, tq=64, batch_size=64)
    assert cm.classmax_scan_split.launches == before
    assert recall_at_k(ids, ds.ground_truth, 10) >= 0.9
    assert np.all(np.diff(dd, axis=1) >= 0)


def test_split_rejects_tables_off_the_quantum(mesh):
    with pytest.raises(ValueError, match="rows"):
        ShardedSplitFlatIndex(torch.zeros((16_384, 16), dtype=torch.int8),
                              torch.zeros((2, 16_384)), 16_384, mesh)
