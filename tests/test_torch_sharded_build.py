"""The port's sharded builds against the JAX package's, on the CPU: the
sharded insert round (``shine_tpu_torch.models.build.
make_sharded_insert_round``), ``device_build_graph(mesh=)``, the online
index's ``mesh=`` (``models/dynamic.py``), ``fast_build_graph(mesh=)``
(``models/fastbuild.py``) and the dry run of every sharded path
(``parallel/dryrun.py``). The JAX side runs on the 8 virtual devices of
``tests/conftest.py``, the port on a CPU mesh of the same S.

Integer-valued rows (``rng.integers(-8, 9)``) make every distance exact in
both packages, so there each sharded build equals the JAX package's
sharded build and the port's single build bit for bit. A sharded round
writes what the single round writes unless a shard's slice draws more
upper nodes than its ``B_up_loc`` and demotes one that the single round
keeps; the sizes and seeds here are ones where that does not happen, and
each test checks so: the stored levels equal the draw. Gaussian rows only
for the online index's recall, the JAX package's bar. Torch runs on one
thread, as in the other build tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shine_tpu.models.fastbuild as jfb
from shine_tpu.config import HNSWParams as JHNSWParams
from shine_tpu.models import build as jbuild
from shine_tpu.models.dynamic import DynamicHNSWIndex as JDynamic
from shine_tpu.parallel import shard_mesh as jax_mesh
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu_torch.models import build as tbuild
from shine_tpu_torch.models import fastbuild as tfb
from shine_tpu_torch.models.dynamic import DynamicHNSWIndex
from shine_tpu_torch.parallel import ShardedIndex, dryrun_mesh, shard_mesh

D = 16
FIELDS = ("levels", "neighbors0", "upper_row", "upper_neighbors")
# the JAX package's sharded-round test (tests/test_build.py:74-117): 800
# rows, 400 inserted in rounds of 64, M=8, ef_construction=40; the single
# round at B_up = B, each shard at B_up_loc = B / S
ROUND_N, ROUND_INSERTED, ROUND_B, ROUND_M, ROUND_EFC = 800, 400, 64, 8, 40
# device_build_graph ramped 16, 32: two round shapes for JAX to compile
BUILD_N, RAMP = 1000, dict(batch_size=32, first_batch=16)
# the JAX package's online tests (tests/test_build.py:231-258)
ONLINE_N, ONLINE_M, ONLINE_EFC, ONLINE_BATCH = 1200, 12, 80, 128
ONLINE_CHUNKS = ((0, 500), (500, 1000), (1000, 1200))
ONLINE_MIN_RECALL = 0.93
# the fastbuild's kNN stage shards above this many rows (the JAX test's)
SHARD_KNN_MIN = 256
S = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _int_rows(seed: int, n: int, d: int = D) -> np.ndarray:
    return np.random.default_rng(seed).integers(-8, 9, size=(n, d)).astype(np.float32)


def _params(m: int, efc: int):
    return JHNSWParams(M=m, ef_construction=efc), HNSWParams(M=m, ef_construction=efc)


def _same_graph(got, want) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.entry_point, got.top_level) == (int(want.entry_point),
                                                int(want.top_level))


def _undemoted(levels: np.ndarray, params: HNSWParams, n: int) -> None:
    """No shard demoted an upper node: the levels are the draw's."""
    drawn = np.minimum(tbuild.draw_levels(n, params), tbuild.LEVEL_CAP)
    np.testing.assert_array_equal(levels[:n], drawn[:n])


# --- the sharded insert round -------------------------------------------------

ROUND_ROWS = _int_rows(31, ROUND_N)
ROUND_KW = dict(ef=ROUND_EFC, frontier=4, max_add=2 * ROUND_M, metric=0)


def _round_batches():
    count = 1
    while count < ROUND_INSERTED:
        b = min(ROUND_B, ROUND_INSERTED - count)
        ids = np.full(ROUND_B, -1, np.int32)
        ids[:b] = np.arange(count, count + b, dtype=np.int32)
        yield ids
        count += b


TABLES = ("levels", "neighbors0", "degree0", "upper_neighbors", "upper_degree")


def _tables(st) -> dict:
    """The state's tables as numpy; a port state's without its spare rows."""
    if not isinstance(st, tbuild.BuildState):
        return {f: np.asarray(getattr(st, f)) for f in TABLES}
    return {f: getattr(st, f).numpy()[: None if f == "levels" else -1] for f in TABLES}


@pytest.fixture(scope="module")
def jax_sharded_round():
    jp, _ = _params(ROUND_M, ROUND_EFC)
    st = jbuild.init_build_state(ROUND_ROWS, jp)
    run = jbuild.make_sharded_insert_round(jax_mesh(S), B_up_loc=ROUND_B // S,
                                           **ROUND_KW)
    for ids in _round_batches():
        st = run(st, jnp.asarray(ids))
    return st


def _port_rounds(shards: int) -> tbuild.BuildState:
    _, tp = _params(ROUND_M, ROUND_EFC)
    st = tbuild.init_build_state(ROUND_ROWS, tp, device="cpu")
    if shards == 1:
        for ids in _round_batches():
            tbuild.insert_round(st, ids, B_up=ROUND_B, **ROUND_KW)
        return st
    mesh = shard_mesh(shards, device="cpu")
    states = tbuild.replicate_build_state(st, mesh)
    assert all(s is st for s in states)  # one device: one state
    run = tbuild.make_sharded_insert_round(mesh, B_up_loc=ROUND_B // shards,
                                           **ROUND_KW)
    for ids in _round_batches():
        run(states, ids)
    return st


@pytest.fixture(scope="module")
def port_single_round():
    return _port_rounds(1)


def _same_states(got: tbuild.BuildState, want) -> None:
    w = _tables(want)
    for f, a in _tables(got).items():
        np.testing.assert_array_equal(a, w[f], err_msg=f)
    assert got.entry_point == int(want.entry_point)
    assert got.entry_level == int(want.entry_level)
    assert got.count == int(want.count) == ROUND_INSERTED


def test_sharded_round_against_jax(jax_sharded_round, port_single_round):
    """S=4: the port's sharded rounds equal the JAX package's sharded rounds
    and the port's single rounds, every table and scalar."""
    got = _port_rounds(S)
    _same_states(got, jax_sharded_round)
    _same_states(port_single_round, jax_sharded_round)
    _undemoted(got.levels.numpy(), HNSWParams(M=ROUND_M), ROUND_N)


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_round_equals_the_single_round(shards, port_single_round):
    _same_states(_port_rounds(shards), port_single_round)


def test_apply_ignores_the_plans_row_order():
    """The gathered plan holds each shard's upper sub-batch with its own -1
    pads: the apply must write the same whatever the order of the plan's
    rows and pads (tests/test_build.py's sharded test relies on it)."""
    _, tp = _params(ROUND_M, ROUND_EFC)
    states = [tbuild.init_build_state(ROUND_ROWS, tp, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(5)
    for ids in _round_batches():
        plan = tbuild.plan_round(states[0], torch.from_numpy(ids), ef=ROUND_EFC,
                                 frontier=4, metric=0, B_up=ROUND_B)
        pb = torch.from_numpy(rng.permutation(ROUND_B))
        pu = torch.from_numpy(rng.permutation(plan.up_ids.shape[0]))
        shuffled = plan._replace(
            batch_ids=plan.batch_ids[pb], node_level=plan.node_level[pb],
            sel_l0=plan.sel_l0[pb], n_sel_l0=plan.n_sel_l0[pb],
            up_ids=plan.up_ids[pu], sel_up=plan.sel_up[pu], n_sel_up=plan.n_sel_up[pu])
        tbuild.apply_round(states[0], plan, metric=0, max_add=2 * ROUND_M)
        tbuild.apply_round(states[1], shuffled, metric=0, max_add=2 * ROUND_M)
    _same_states(states[1], states[0])


def test_sharded_round_refuses_what_it_cannot_split():
    _, tp = _params(ROUND_M, ROUND_EFC)
    st = tbuild.init_build_state(ROUND_ROWS, tp, device="cpu")
    mesh = shard_mesh(3, device="cpu")
    run = tbuild.make_sharded_insert_round(mesh, B_up_loc=8, **ROUND_KW)
    with pytest.raises(ValueError, match="do not split"):
        run(tbuild.replicate_build_state(st, mesh), np.arange(1, 65, dtype=np.int32))
    with pytest.raises(ValueError, match="states"):
        run([st], np.arange(1, 64, dtype=np.int32))
    with pytest.raises(ValueError, match="first shard"):
        tbuild.device_build_graph(ROUND_ROWS, tp, mesh=shard_mesh(2, device="cpu"),
                                  device="cuda")


# --- device_build_graph(mesh=) ----------------------------------------------------


def test_device_build_graph_mesh_against_jax():
    """~1,000 integer rows in rounds of 16, then 32: the port's mesh build equals
    the JAX package's mesh build and the port's single build; the timings
    add the mesh's halves."""
    rows = _int_rows(32, BUILD_N)
    jp, tp = _params(ROUND_M, ROUND_EFC)
    want = jbuild.device_build_graph(rows, jp, mesh=jax_mesh(S), **RAMP)
    timings = {}
    got = tbuild.device_build_graph(rows, tp, mesh=shard_mesh(S, device="cpu"),
                                    timings=timings, **RAMP)
    _same_graph(got, want)
    _same_graph(tbuild.device_build_graph(rows, tp, device="cpu", **RAMP), want)
    _undemoted(got.levels, tp, BUILD_N)
    assert {"plan", "gather", "apply", "rounds", "l0_search"} <= set(timings)
    assert timings["plan"] >= timings["l0_search"]
    got.validate()


# --- DynamicHNSWIndex(mesh=) --------------------------------------------------------


def test_online_index_mesh_against_jax():
    """The JAX package's online sizes on integer rows: after each chunk the
    port's mesh snapshot equals the JAX mesh index's and the port's single
    index's; the searcher is a ShardedIndex."""
    rows = _int_rows(33, ONLINE_N)
    jp, tp = _params(ONLINE_M, ONLINE_EFC)
    kw = dict(capacity=ONLINE_N, batch_size=ONLINE_BATCH)
    jd = JDynamic(D, params=jp, mesh=jax_mesh(S), **kw)
    td = DynamicHNSWIndex(D, params=tp, mesh=shard_mesh(S, device="cpu"), **kw)
    single = DynamicHNSWIndex(D, params=tp, device="cpu", **kw)
    for lo, hi in ONLINE_CHUNKS:
        for index in (jd, td, single):
            index.add(rows[lo:hi])
        want = jd.snapshot()
        _same_graph(td.snapshot(), want)
        _same_graph(single.snapshot(), want)
    _undemoted(td.snapshot().levels, tp, ONLINE_N)
    assert isinstance(td.searcher(), ShardedIndex)
    assert len(td._sharded_runs) == 4  # rounds of 16, 32, 64 and 128


def test_online_index_mesh_recall():
    """Gaussian rows, the JAX package's own online test on a mesh: the
    ShardedIndex searcher's recall@10 above its bar after every chunk."""
    ds = synthetic_dataset(n=3000, dim=24, num_queries=100, seed=5)
    base = ds.base[:ONLINE_N]
    index = DynamicHNSWIndex(24, capacity=ONLINE_N,
                             params=HNSWParams(M=ONLINE_M, ef_construction=ONLINE_EFC),
                             batch_size=ONLINE_BATCH, mesh=shard_mesh(S, device="cpu"))
    for lo, hi in ONLINE_CHUNKS:
        index.add(base[lo:hi])
        searcher = index.searcher()
        searcher.graph.validate()
        gt, _ = brute_force_knn(base[:hi], ds.queries, 10)
        ids, _ = searcher.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
        assert recall_at_k(ids, gt, 10) > ONLINE_MIN_RECALL


# --- fast_build_graph(mesh=) ------------------------------------------------------


def test_fast_build_graph_mesh(monkeypatch):
    """SHARD_KNN_MIN lowered in both packages: the port's CPU mesh build (the
    exact sharded scan) equals its single builds and the JAX package's mesh
    build in interpret mode; the mesh serves it back with the single
    index's ids (tests/test_build.py:127-158)."""
    monkeypatch.setattr(tfb, "SHARD_KNN_MIN", SHARD_KNN_MIN)
    monkeypatch.setattr(jfb, "SHARD_KNN_MIN", SHARD_KNN_MIN)
    rows = _int_rows(34, 3000)
    queries = _int_rows(35, 64)
    jp, tp = _params(8, 60)
    mesh = shard_mesh(S, device="cpu")
    got = tfb.fast_build_graph(rows, tp, mesh=mesh)
    _same_graph(got, jfb.fast_build_graph(rows, jp, interpret=True, mesh=jax_mesh(S)))
    for blockmax in (False, True):
        _same_graph(tfb.fast_build_graph(rows, tp, device="cpu", blockmax=blockmax), got)
    assert (got.levels >= 1).sum() > SHARD_KNN_MIN  # level 1 sharded too
    sp = SearchParams(k=10, ef=48)
    sids, _ = ShardedIndex(got, mesh).search(queries, sp, batch_size=64)
    oids, _ = HNSWIndex(got, device="cpu").search(queries, sp, batch_size=64)
    np.testing.assert_array_equal(sids, oids)


# --- the dry run --------------------------------------------------------------------


def test_dryrun_mesh_on_the_cpu():
    seconds = dryrun_mesh(8, device="cpu")
    assert set(seconds) == {"tiny_graph", "insert_round", "fastbuild", "sharded_index",
                            "flat", "capacity", "routed"}
