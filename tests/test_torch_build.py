"""The port's insert rounds (shine_tpu_torch.models.build), its online index
(models/dynamic.py) and GraphSoA.validate against the JAX package's
``shine_tpu.models.build``, ``shine_tpu.models.dynamic`` and
``shine_tpu.graph.soa``, on the CPU.

Integer-valued rows make every distance exact in both packages, so there
each stage of a round (from a state carried over by
``build_state_from_jax``), a whole ``device_build_graph`` and a
``DynamicHNSWIndex`` snapshot must equal the JAX package's bit for bit. On
Gaussian rows the two sum distances in other orders (ROADMAP C5), one
flipped selection changes every later round, and the graphs are held to
each other by recall. Torch runs on one thread, as the JAX package's CPU
tests effectively do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams as JHNSWParams
from shine_tpu.graph.soa import GraphSoA as JGraphSoA
from shine_tpu.models import build as jbuild
from shine_tpu.models.dynamic import DynamicHNSWIndex as JDynamic
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.config import METRIC_L2, HNSWParams, SearchParams
from shine_tpu_torch.convert import build_state_from_jax
from shine_tpu_torch.graph.soa import GraphSoA
from shine_tpu_torch.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu_torch.models import build as tbuild
from shine_tpu_torch.models.dynamic import DynamicHNSWIndex

# one shape for the carried state, both builds and the online index, so that
# the JAX package compiles each round's shape once
N, D, M, EFC = 2000, 16, 8, 40
RAMP = dict(batch_size=128, first_batch=16)
B, ROUNDS = 64, 6  # the carried state: 6 JAX rounds of 64 after the bootstrap
B_UP = tbuild.upper_batch(B, M)  # as device_build_graph's rounds of 64
FIELDS = ("levels", "neighbors0", "upper_row", "upper_neighbors")
STATE_TABLES = ("vectors", "vec_sqnorms", "levels", "upper_row", "neighbors0",
                "degree0", "upper_neighbors", "upper_degree")
# Gaussian rows: graph recall@10 of the two builds, each served by the
# port's search, may differ by at most this
RECALL_GAP = 0.01
# the JAX package's own bound for the online index between chunks
# (tests/test_build.py:test_dynamic_online_insert)
ONLINE_MIN_RECALL = 0.93


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _int_rows(seed: int, n: int = N, d: int = D) -> np.ndarray:
    return np.random.default_rng(seed).integers(-4, 5, size=(n, d)).astype(np.float32)


def _params(metric: str = "l2", m: int = M, efc: int = EFC):
    return (JHNSWParams(M=m, ef_construction=efc, metric=metric),
            HNSWParams(M=m, ef_construction=efc, metric=metric))


def _arrays(st) -> dict:
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _same_state(got: tbuild.BuildState, want) -> None:
    """Every table of the port's state (its spare rows cut) and every scalar
    equal to the JAX state's, floats as bits."""
    for f in STATE_TABLES:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()[: w.shape[0]]
        if w.dtype == np.float32:
            w, g = w.view(np.int32), g.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.entry_point == int(want.entry_point)
    assert got.entry_level == int(want.entry_level)
    assert got.count == int(want.count)


def _ids(lo: int, b: int = B) -> np.ndarray:
    return np.arange(lo, lo + b, dtype=np.int32)


@pytest.fixture(scope="module", params=["l2", "ip"])
def carried(request):
    """(metric id, the JAX state after ROUNDS rounds of B on integer rows,
    the next batch's ids)."""
    jp, _ = _params(request.param)
    st = jbuild.init_build_state(_int_rows(1), jp)
    for r in range(ROUNDS):
        st = jbuild.insert_round(st, jnp.asarray(_ids(1 + r * B)), ef=EFC, frontier=4,
                                 max_add=2 * M, metric=jp.metric_id, B_up=B_UP)
    return jp.metric_id, st, _ids(1 + ROUNDS * B)


_jax_plan = jax.jit(jbuild.plan_round, static_argnames=("ef", "frontier", "metric",
                                                        "B_up"))
_jax_shrink = jax.jit(jbuild._shrink_overflow, static_argnums=(5, 6))


def _port(st) -> tbuild.BuildState:
    return build_state_from_jax(_arrays(st), device="cpu")


def _queries(jst, ts, ids, metric):
    """The batch's query terms in both packages."""
    j = jnp.asarray(ids)
    q, qn = jst.vectors[j], jst.vec_sqnorms[j]
    q_ext, bias = tbuild._query_ext(ts, torch.from_numpy(ids).long(),
                                    metric == METRIC_L2)
    return (q, qn), (q_ext, bias)


def _t(a) -> torch.Tensor:
    """A torch copy of a (read-only) JAX output."""
    return torch.from_numpy(np.array(a))


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_init_build_state_field_by_field():
    for metric in ("l2", "ip"):
        jp, tp = _params(metric)
        rows = np.random.default_rng(2).normal(size=(3000, 24)).astype(np.float32)
        want = jbuild.init_build_state(rows, jp, level_cap=5)
        got = tbuild.init_build_state(rows, tp, level_cap=5, device="cpu")
        _same_state(got, want)
        # the spare rows: empty lists, degree 0
        assert got.neighbors0.shape[0] == want.neighbors0.shape[0] + 1
        assert (got.neighbors0[-1] == -1).all() and int(got.degree0[-1]) == 0
        assert (got.upper_neighbors[-1] == -1).all()
        assert (got.upper_degree[-1] == 0).all()


@pytest.mark.parametrize("case", range(4))
def test_apply_reverse_edges_bit_for_bit(case):
    """Random request sets with repeated vertices, -1 pads and lists that
    overflow, on layer 0 (rows are ids) and on an upper level (rows through
    a permutation), against ``_apply_reverse_edges`` of the JAX package."""
    rng = np.random.default_rng(40 + case)
    R, cap, E = 40, 6, 300
    deg = rng.integers(0, cap + 1, R).astype(np.int32)
    table = np.full((R, cap), -1, np.int32)
    for r in range(R):
        table[r, : deg[r]] = rng.choice(1000, deg[r], replace=False)
    vertices = rng.integers(0, R // (1 + case % 2), E).astype(np.int32)
    new_ids = (1000 + rng.permutation(E)).astype(np.int32)
    pads = rng.random(E) < 0.2
    vertices[pads], new_ids[pads] = -1, -1
    perm = rng.permutation(R).astype(np.int32)
    row_j = (lambda x: x) if case < 2 else (lambda x: jnp.asarray(perm)[x])
    row_t = (lambda x: x) if case < 2 else (lambda x: torch.from_numpy(perm)[x.long()])
    want = jbuild._apply_reverse_edges(jnp.asarray(table), jnp.asarray(deg), row_j,
                                       jnp.asarray(vertices), jnp.asarray(new_ids))
    t_table = torch.from_numpy(np.concatenate([table, np.full((1, cap), -1, np.int32)]))
    t_deg = torch.from_numpy(np.concatenate([deg, [0]]).astype(np.int32))
    got = tbuild._apply_reverse_edges(t_table, t_deg, row_t, torch.from_numpy(vertices),
                                      torch.from_numpy(new_ids))
    np.testing.assert_array_equal(t_table.numpy()[:R], np.asarray(want[0]))
    np.testing.assert_array_equal(t_deg.numpy()[:R], np.asarray(want[1]))
    for g, w in zip(got, want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[5]) >= 0).sum() > 0  # some list overflowed


def test_greedy_to_level_bit_for_bit(carried):
    metric, jst, ids = carried
    ts = _port(jst)
    (q, qn), (q_ext, bias) = _queries(jst, ts, ids, metric)
    assert ts.entry_level >= 2
    for target in (np.zeros(B, np.int32), np.minimum(np.asarray(jst.levels)[ids], 1)):
        want = jbuild._greedy_to_level(jst, q, qn, jnp.asarray(target), metric)
        got = tbuild._greedy_to_level(ts, q_ext, bias, torch.from_numpy(target),
                                      metric == METRIC_L2)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))


@pytest.mark.parametrize("level", [0, 1])
def test_search_level_bit_for_bit(carried, level):
    """Both levels through the gated beam_step loop (its CPU twin here), over
    the level's list table by id (neighbors0 on layer 0, the (N, M) upper
    lists on level 1), each seeded by the greedy descent to the level
    above."""
    metric, jst, ids = carried
    ts = _port(jst)
    (q, qn), (q_ext, bias) = _queries(jst, ts, ids, metric)
    target = jnp.full(B, level, jnp.int32)
    ep, ep_d = jbuild._greedy_to_level(jst, q, qn, target, metric)
    want = jbuild._search_level(jst, q, qn, ep, ep_d, jnp.int32(level), EFC, 4, metric)
    got = tbuild._search_level(ts, q_ext, bias, _t(ep), _t(ep_d), level, EFC, 4,
                               metric == METRIC_L2)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(_bits(got.dists), _bits(want.dists))
    np.testing.assert_array_equal(got.expanded.numpy(), np.asarray(want.expanded))
    assert (np.asarray(want.ids) >= 0).sum(axis=1).min() > 1


def _before_shrink(jst, ids, metric, level):
    """The JAX state after one level's own rows and reverse edges of the
    next round's plan, and the re-prune's inputs (overflow vertices,
    rejected requests, their new ids)."""
    plan = _jax_plan(jst, jnp.asarray(ids), ef=EFC, frontier=4, metric=metric,
                     B_up=B_UP)
    if level == 0:
        sel, n_sel, who = plan.sel_l0, plan.n_sel_l0, plan.batch_ids
        s = jbuild._write_own_l0(jst, who, sel, n_sel, n_sel > 0)
    else:
        sel, n_sel, who = plan.sel_up[:, level - 1], plan.n_sel_up[:, level - 1], plan.up_ids
        s = jbuild._write_own_upper(jst, who, sel, n_sel, level - 1, n_sel > 0)
    flat_v = sel.reshape(-1)
    flat_u = jnp.where(flat_v >= 0, jnp.broadcast_to(who[:, None], sel.shape).reshape(-1), -1)
    if level == 0:
        nbr, deg, sv, su, ok, over = jbuild._apply_reverse_edges(
            s.neighbors0, s.degree0, lambda x: x, flat_v, flat_u)
        s = s._replace(neighbors0=nbr, degree0=deg)
    else:
        lm1 = level - 1
        nbr, deg, sv, su, ok, over = jbuild._apply_reverse_edges(
            s.upper_neighbors[:, lm1, :], s.upper_degree[:, lm1],
            lambda x: s.upper_row[x], flat_v, flat_u)
        s = s._replace(upper_neighbors=s.upper_neighbors.at[:, lm1, :].set(nbr),
                       upper_degree=s.upper_degree.at[:, lm1].set(deg))
    return s, over, jnp.where(ok, -1, sv), su


@pytest.mark.parametrize("level", [0, 1])
def test_shrink_overflow_bit_for_bit(carried, level):
    metric, jst, ids = carried
    s, over, rejected, su = _before_shrink(jst, ids, metric, level)
    assert int((over >= 0).sum()) > 0  # some list overflowed at this level
    want = _jax_shrink(s, over, rejected, su, jnp.int32(level - 1), metric, 2 * M)
    ts = _port(s)
    tbuild._shrink_overflow(ts, _t(over), _t(rejected), _t(su), level - 1, metric,
                            2 * M)
    _same_state(ts, want)


def test_insert_round_bit_for_bit(carried):
    """One whole round from the carried state: the plan field by field, then
    the state after the apply."""
    metric, jst, ids = carried
    kw = dict(ef=EFC, frontier=4, metric=metric, B_up=B_UP)
    want_plan = _jax_plan(jst, jnp.asarray(ids), **kw)
    ts = _port(jst)
    got_plan = tbuild.plan_round(ts, torch.from_numpy(ids), **kw)
    for f in want_plan._fields:
        np.testing.assert_array_equal(getattr(got_plan, f).numpy(),
                                      np.asarray(getattr(want_plan, f)), err_msg=f)
    want = jbuild.insert_round(jst, jnp.asarray(ids), max_add=2 * M, **kw)
    timings = {}
    tbuild.insert_round(ts, ids, max_add=2 * M, timings=timings, **kw)
    _same_state(ts, want)
    assert set(timings) == set(tbuild.STAGES)


def test_insert_round_demotes_past_b_up():
    """A round whose upper sub-batch overflows (B_up = 8 at M=4, where a
    quarter of the nodes draw a level above 0): the demotions, the plan's
    count of them and the state equal the JAX package's."""
    jp, tp = _params("l2", m=4, efc=24)
    rows = _int_rows(3, 700, 12)
    jst = jbuild.init_build_state(rows, jp)
    ts = tbuild.init_build_state(rows, tp, device="cpu")
    demoted = 0
    for r in range(6):
        ids = _ids(1 + r * B)
        kw = dict(ef=24, frontier=4, metric=jp.metric_id, B_up=8)
        demoted += int(tbuild.plan_round(ts, torch.from_numpy(ids), **kw).up_overflow[0])
        jst = jbuild.insert_round(jst, jnp.asarray(ids), max_add=8, **kw)
        tbuild.insert_round(ts, ids, max_add=8, **kw)
    _same_state(ts, jst)
    assert demoted > 0


def test_lists_hold_no_uninserted_id_when_a_round_plans():
    """The JAX package masks list entries >= count in every search; the port
    does not, because a plan never finds one: before each round every list
    entry (layer 0 and upper) is -1 or below ``count``, and the rows of the
    nodes not yet inserted are empty."""
    _, tp = _params("l2")
    st = tbuild.init_build_state(_int_rows(4, 800), tp, device="cpu")
    for r in range(8):
        n0 = st.neighbors0[: st.n]
        assert int(n0.max()) < st.count and (n0[st.count:] == -1).all()
        up = st.upper_neighbors[:-1]
        assert int(up.max()) < st.count
        tbuild.insert_round(st, _ids(1 + r * 96, 96), ef=EFC, frontier=4,
                            max_add=2 * M, metric=METRIC_L2, B_up=32)
    assert st.count == 1 + 8 * 96


@pytest.fixture(scope="module")
def int_builds():
    rows = _int_rows(5)
    jp, tp = _params("l2")
    want = jbuild.device_build_graph(rows, jp, **RAMP)
    got = tbuild.device_build_graph(rows, tp, device="cpu", **RAMP)
    return got, want


def test_device_build_graph_bit_for_bit_on_integer_rows(int_builds):
    got, want = int_builds
    for f in FIELDS + ("vectors",):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.entry_point, got.top_level) == (want.entry_point, want.top_level)
    got.validate()


def test_device_build_graph_recall_on_gaussian_rows():
    """Gaussian rows: the port's graph is valid, and its recall@10 (served by
    the port's search, as is the JAX graph) is within RECALL_GAP of the
    JAX build's."""
    ds = synthetic_dataset(n=N, dim=D, num_queries=200, seed=6)
    jp, tp = _params("l2")
    want = GraphSoA.from_fields(jbuild.device_build_graph(ds.base, jp, **RAMP))
    got = tbuild.device_build_graph(ds.base, tp, device="cpu", **RAMP)
    got.validate()
    sp = SearchParams(k=10, ef=48)
    recalls = [recall_at_k(HNSWIndex(g, device="cpu").search(ds.queries, sp,
                                                             batch_size=200)[0],
                           ds.ground_truth, 10) for g in (got, want)]
    assert abs(recalls[0] - recalls[1]) <= RECALL_GAP, recalls
    assert recalls[0] > 0.9, recalls


def _graph_pair(graph: GraphSoA):
    """The port's graph and the JAX package's GraphSoA of the same arrays."""
    p = graph.params
    jg = JGraphSoA(params=JHNSWParams(M=p.M, ef_construction=p.ef_construction,
                                      metric=p.metric, seed=p.seed),
                   **{f: getattr(graph, f).copy() for f in FIELDS + ("vectors",)},
                   entry_point=graph.entry_point, top_level=graph.top_level)
    return graph, jg


def _self_loop(g):
    g.neighbors0[7, 0] = 7


def _edge_to_lower_level(g):
    v = int(np.where(g.levels >= 1)[0][0])
    g.upper_neighbors[g.upper_row[v], 0, 0] = int(np.where(g.levels == 0)[0][0])


def _entry_off_top(g):
    g.entry_point = int(np.where(g.levels == 0)[0][0])


@pytest.mark.parametrize("break_it", [None, _self_loop, _edge_to_lower_level,
                                      _entry_off_top])
def test_validate_accepts_and_rejects_as_the_jax_package(int_builds, break_it):
    import copy

    for g in _graph_pair(copy.deepcopy(int_builds[0])):
        if break_it is None:
            g.validate()
            continue
        break_it(g)
        with pytest.raises(AssertionError):
            g.validate()


def test_online_index_snapshots_bit_for_bit_on_integer_rows():
    rows = _int_rows(8)
    jp, tp = _params("l2")
    kw = dict(capacity=N, batch_size=RAMP["batch_size"])
    jd = JDynamic(D, params=jp, **kw)
    td = DynamicHNSWIndex(D, params=tp, device="cpu", **kw)
    for lo, hi in ((0, 500), (500, 1200), (1200, 1900)):
        jd.add(rows[lo:hi])
        td.add(rows[lo:hi])
        want, got = jd.snapshot(), td.snapshot()
        for f in FIELDS + ("vectors",):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert (got.entry_point, got.top_level) == (want.entry_point, want.top_level)
        got.validate()


def test_online_index_recall_between_chunks():
    """The JAX package's own online test, on the port: three chunks of
    Gaussian rows, the searcher served after each, recall@10 above its
    bound; a chunk past the capacity, a mesh and a wrong width raise."""
    ds = synthetic_dataset(n=1200, dim=24, num_queries=100, seed=5)
    dyn = DynamicHNSWIndex(24, capacity=1300, params=HNSWParams(M=12, ef_construction=80),
                           batch_size=128, device="cpu")
    for hi in (300, 800, 1200):
        dyn.add(ds.base[dyn.count:hi])
        idx = dyn.searcher(rows="bf16")
        assert idx.device_graph.vectors_ext.dtype == torch.bfloat16
        idx = dyn.searcher()
        idx.graph.validate()
        gt, _ = brute_force_knn(ds.base[:hi], ds.queries, 10)
        ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=100)
        assert recall_at_k(ids, gt, 10) > ONLINE_MIN_RECALL
    with pytest.raises(ValueError, match="capacity"):
        dyn.add(np.zeros((101, 24), np.float32))
    with pytest.raises(ValueError):
        dyn.add(np.zeros((1, 23), np.float32))
    with pytest.raises(NotImplementedError, match="A8c"):
        DynamicHNSWIndex(24, 100, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        DynamicHNSWIndex(24, 100, device="cpu").snapshot()


def test_entry_points_default_to_the_card_and_refuse_a_mesh():
    rows = _int_rows(9, 100)
    _, tp = _params("l2")
    with pytest.raises(NotImplementedError, match="A8c"):
        tbuild.device_build_graph(rows, tp, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A8c"):
        tbuild.make_sharded_insert_round(None, ef=EFC, frontier=4, max_add=16,
                                         metric=0, B_up_loc=8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tbuild.device_build_graph(rows, tp)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DynamicHNSWIndex(D, 100, tp)
