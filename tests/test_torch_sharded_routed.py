"""The port's cluster-sharded routed serving (shine_tpu_torch.parallel.
routed_sharded) against shine_tpu.parallel.routed_sharded: ``from_single``
with a row source and in base mode, ``build_routed_split(shards=)`` and the
direct sharded build. The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py`` (its routed kernel through XLA off the TPU); the port
on a CPU mesh of 8 shards.

Both packages serve one JAX build: the single index carried over by
``routed_split_from_jax`` and dealt by each package's ``from_single``, the
JAX direct build carried over by ``sharded_routed_from_jax``. Integer rows
in base mode (every product and sum exact): ids and distances bit for bit,
and coverage, overflow, lanes, the spilled count and the analytic counts
equal. Rows regenerated from a key (normals a few ulps apart, ROADMAP C5):
ids on >= 99% of slots, the counters equal. The port's own builds: the
direct build equals ``from_single`` of ``build_routed_split(shards=S)`` bit
for bit, and ``shards=1`` is today's build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.io.device_synth import regen_rows
from shine_tpu.models.routed_split import build_routed_split as jax_build
from shine_tpu.parallel.mesh import shard_mesh as jax_mesh
from shine_tpu.parallel.routed_sharded import ShardedRoutedSplitIndex as JRouted
from shine_tpu.parallel.routed_sharded import build_routed_split_sharded as jax_direct
from shine_tpu_torch.convert import (
    routed_split_from_jax,
    row_source_from_jax,
    sharded_routed_from_jax,
)
from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.io import device_synth as tds
from shine_tpu_torch.models.routed_split import build_routed_split
from shine_tpu_torch.parallel import (
    ShardedRoutedSplitIndex,
    build_routed_split_sharded,
    shard_mesh,
)

S = 8
N, D = 8192, 32
BUILD = dict(cap_target=512, cls=128, train_size=8192, seed=4)
MIN_ID_OVERLAP = 0.99
COUNTERS = ("last_coverage", "last_overflow", "last_lanes", "last_fallback")
# (name, search knobs): the grant without overflow, the auto lane window
# (overflow), a starved window whose spill runs, and the auto knobs
ROUTES = {
    "wide": dict(probes=16, shared=32, tile=32, kk=64, shared_local=32, fallback=0),
    "auto_window": dict(probes=16, shared=32, tile=32),
    "starved_spill": dict(probes=16, shared=32, tile=32, kk=64, shared_local=2,
                          fallback=0.9),
    "auto": dict(),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def _single_arrays(idx) -> dict:
    return {"centroids": _np(idx.centroids), "comp": _np(idx.comp),
            "aux_r": _np(idx.aux_r), "gid": _np(idx.gid)}


@pytest.fixture(scope="module")
def regen_case():
    key = jax.random.PRNGKey(9)
    centers = jax.random.normal(jax.random.PRNGKey(1), (16, D)) * 4.0
    rng = np.random.default_rng(2)
    queries = (_np(regen_rows(key, centers, jnp.arange(64, dtype=jnp.int32)))
               + rng.normal(size=(64, D)).astype(np.float32) * 0.3)
    jidx = jax_build(N, D, row_source=(key, centers), shards=S, **BUILD)
    rs = row_source_from_jax(_np(key), _np(centers), device="cpu")
    tidx = routed_split_from_jax(_single_arrays(jidx), n=N, dim=D, metric="l2",
                                 cls=jidx.cls, cap=jidx.cap, device="cpu", row_source=rs)
    return key, centers, rs, queries, jidx, tidx


@pytest.fixture(scope="module")
def base_case():
    rng = np.random.default_rng(5)
    base = rng.integers(-8, 9, size=(N, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(64, 16)).astype(np.float32)
    jidx = jax_build(N, 16, base_dev=jnp.asarray(base), shards=S, **BUILD)
    arrays = _single_arrays(jidx) | {"base": base}
    tidx = routed_split_from_jax(arrays, n=N, dim=16, metric="l2", cls=jidx.cls,
                                 cap=jidx.cap, device="cpu")
    return queries, JRouted.from_single(jidx, jax_mesh(S)), \
        ShardedRoutedSplitIndex.from_single(tidx, shard_mesh(S, device="cpu"))


@pytest.mark.parametrize("route", list(ROUTES))
def test_base_mode_bit_for_bit(base_case, route):
    queries, j, t = base_case
    kw = {"batch_size": 64, **ROUTES[route]}
    ji, jd = j.search(queries, 10, **kw)
    ti, td = t.search(queries, 10, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), np.asarray(jd).view(np.int32))
    for c in COUNTERS:
        assert getattr(t, c) == getattr(j, c), c
    if route == "starved_spill":
        assert t.last_overflow > 0 and t.last_fallback > 0


def test_regen_from_single_against_jax(regen_case):
    _, _, _, queries, jidx, tidx = regen_case
    j = JRouted.from_single(jidx, jax_mesh(S))
    t = ShardedRoutedSplitIndex.from_single(tidx, shard_mesh(S, device="cpu"))
    for route, kw in ROUTES.items():
        ji, _ = j.search(queries, 10, batch_size=64, **kw)
        ti, td = t.search(queries, 10, batch_size=64, **kw)
        assert (ti == np.asarray(ji)).mean() >= MIN_ID_OVERLAP, route
        assert np.all(np.diff(td, axis=1) >= 0)
        for c in COUNTERS:
            assert getattr(t, c) == getattr(j, c), (route, c)
    # the re-dealt gid holds every row once
    gid = torch.cat(t.gid).numpy()
    np.testing.assert_array_equal(np.sort(gid[gid >= 0]), np.arange(N))


def test_cost_counters_match_jax(base_case):
    """The counts equal the JAX package's but the table bytes, which follow
    each package's row width (the JAX rows are padded to 128 lanes)."""
    _, j, t = base_case
    kw = dict(probes=16, shared=32, tile=32)
    jc, tc = j.cost_counters(1000, **kw), t.cost_counters(1000, **kw)
    for key in ("distance_computations", "scanned_rows", "ici_exchange_bytes"):
        assert tc[key] == jc[key], key
    jrow = j.comp.shape[1] + 12
    trow = t.comp[0].shape[1] + 12
    assert tc["hbm_gather_bytes"] * jrow == jc["hbm_gather_bytes"] * trow


def test_jax_direct_build_served_by_the_port(regen_case):
    """The JAX direct build's per-shard tables (ingest pads kept) carried
    over: the port serves them as the JAX index does."""
    key, centers, rs, queries, _, _ = regen_case
    jb = jax_direct(N, D, jax_mesh(S), row_source=(key, centers), **BUILD)
    t = sharded_routed_from_jax(
        {"centroids": _np(jb.centroids), "comp": _np(jb.comp), "aux_r": _np(jb.aux_r),
         "gid": _np(jb.gid)}, n=N, dim=D, metric="l2", cls=jb.cls, cap=jb.cap,
        mesh=shard_mesh(S, device="cpu"), row_source=rs)
    assert (t.C, t.cap) == (jb.C, jb.cap)
    kw = ROUTES["auto_window"]
    ji, _ = jb.search(queries, 10, batch_size=64, **kw)
    ti, _ = t.search(queries, 10, batch_size=64, **kw)
    assert (ti == np.asarray(ji)).mean() >= MIN_ID_OVERLAP
    assert (t.last_coverage, t.last_overflow) == (jb.last_coverage, jb.last_overflow)


@pytest.fixture(scope="module")
def port_builds():
    k1, centers, q = tds._rowkeyed_recipe(16_384, 16, 32, 16, 5, True,
                                          torch.device("cpu"))
    mesh = shard_mesh(4, device="cpu")
    kw = dict(cap_target=512, cls=128, train_size=8192, seed=3)
    single, gt = build_routed_split(16_384, 16, row_source=(k1, centers), shards=4,
                                    queries=q.numpy(), **kw)
    direct, gt2 = build_routed_split_sharded(16_384, 16, mesh, row_source=(k1, centers),
                                             queries=q.numpy(), **kw)
    return single, gt, direct, gt2, q.numpy(), mesh, (k1, centers), kw


def test_direct_build_equals_from_single(port_builds):
    single, gt, direct, gt2, q, mesh, _, _ = port_builds
    assert single.C % 4 == 0 and direct.C == single.C
    dealt = ShardedRoutedSplitIndex.from_single(single, mesh)
    for name in ("comp", "aux_r", "gid"):
        for a, b in zip(getattr(dealt, name), getattr(direct, name)):
            assert torch.equal(a, b), name
    assert torch.equal(dealt.centroids[0], direct.centroids[0])
    np.testing.assert_array_equal(gt, gt2)
    ai, ad = dealt.search(q, 10, batch_size=32)
    bi, bd = direct.search(q, 10, batch_size=32)
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_array_equal(ad, bd)
    assert recall_at_k(bi, gt2, 10) >= 0.9


def test_shards_one_is_the_unsharded_build(port_builds):
    _, _, _, _, _, _, rs, kw = port_builds
    a = build_routed_split(16_384, 16, row_source=rs, **kw)
    b = build_routed_split(16_384, 16, row_source=rs, shards=1, **kw)
    for name in ("comp", "aux_r", "gid", "centroids"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    c = build_routed_split(16_384, 16, row_source=rs, shards=7, **kw)
    assert c.C % 7 == 0 and c.C >= a.C


def test_from_single_refuses(port_builds):
    single, *_ = port_builds
    assert single.C % 5  # C is a multiple of 4, not of 5
    with pytest.raises(ValueError, match="divisible"):
        ShardedRoutedSplitIndex.from_single(single, shard_mesh(5, device="cpu"))
    bare = build_routed_split(16_384, 16, row_source=port_builds[6], **port_builds[7])
    bare.row_source = None
    with pytest.raises(ValueError, match="row_source or its base_dev"):
        ShardedRoutedSplitIndex.from_single(bare, shard_mesh(1, device="cpu"))
