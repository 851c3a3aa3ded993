"""The port's layer-0 beam step (shine_tpu_torch.ops.beam_step) on the CPU:
one plain step against one step of the JAX package's loop body (built from
shine_tpu.ops.beam and shine_tpu.models.hnsw._dist_ext), the exactness of
the fused kernel's duplicate drop (the distances of the lanes it drops
never reach beam_merge's output), and the loop that reads the unsettled
count back every few steps against the one that reads it every step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams
from shine_tpu.graph.soa import build_graph
from shine_tpu.io import synthetic_dataset
from shine_tpu.models import hnsw as jh
from shine_tpu.ops import beam as jb
from shine_tpu_torch import device_graph_from_jax
from shine_tpu_torch.config import SearchParams
from shine_tpu_torch.graph.soa import GraphSoA as PortGraph
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.ops import beam as tb
from shine_tpu_torch.ops import beam_step as bs
from shine_tpu_torch.ops.gather_score import gather_score

# distances of one step: the same terms (up to ~1e2 on this set) summed in
# another order by the two frameworks, a few ulp apart (test_torch_hnsw.py)
RTOL, ATOL = 1e-5, 5e-4


@pytest.fixture(scope="module")
def case():
    ds = synthetic_dataset(n=3000, dim=16, num_queries=48, seed=21)
    return ds, build_graph(ds.base, HNSWParams(M=8, ef_construction=64),
                           threads=1)


def _start(graph, queries, sp, rows, metric, steps):
    """The port's DeviceGraph, q_ext, bias, and the layer-0 state after
    ``steps`` plain steps from the dense entry's seeds."""
    g = th.device_graph(PortGraph.from_fields(graph), rows=rows, device="cpu")
    q_ext, bias = th._extend_query(torch.from_numpy(queries), metric)
    l2 = metric == 0
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, l2)
    state = list(th._l0_state(seed_ids, seed_d, sp))
    for t in range(steps):
        _step(g, q_ext, bias, state, t, sp, l2)
    return g, q_ext, bias, state


def _step(g, q_ext, bias, state, t, sp, l2, fn=None):
    beam, hops, counts, uns = state
    (fn or bs.beam_step)(
        g.vectors_ext, g.neighbors0, q_ext, bias, beam, hops, counts, uns, t,
        frontier=sp.frontier, k=sp.k, term=sp.term, l2=l2, row_scl=g.row_scl,
        row_nrm=g.row_nrm)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("rows,metric,frontier,term,steps", [
    ("f32", 0, 4, "ef", 0),
    ("f32", 0, 4, "ef", 3),
    ("f32", 0, 1, "k", 5),
    ("f32", 1, 8, "ef", 2),
    ("bf16", 0, 4, "k", 3),
    ("bf16", 1, 2, "ef", 1),
    ("int8", 0, 8, "ef", 3),
    ("int8", 1, 4, "k", 2),
])
def test_plain_step_matches_jax_body(case, rows, metric, frontier, term, steps):
    ds, graph = case
    sp = SearchParams(k=10, ef=32, frontier=frontier, term=term).resolved()
    g, q_ext, bias, state = _start(graph, ds.queries, sp, rows, metric, steps)
    beam, hops, counts, uns = state
    # the JAX body on the same beam
    jg, _ = jh.device_graph(graph, rows=rows)
    q = jnp.asarray(ds.queries)
    jq_ext, jbias = jh._extend_query(q, metric, jg.vectors_ext.shape[1])
    jbeam = jb.Beam(*(jnp.asarray(c.numpy()) for c in beam))
    slots, fids, active = jb.beam_frontier_multi(jbeam, frontier)
    jbeam = jb.beam_mark_expanded(jbeam, slots, active)
    active = np.asarray(active)
    nbrs = graph.neighbors0[np.maximum(np.asarray(fids), 0)]
    nbrs = np.where(active[:, :, None], nbrs, -1).reshape(len(q), -1)
    d = jh._dist_ext(jg, jq_ext, jbias, jnp.asarray(nbrs), l2=metric == 0)
    jbeam = jb.beam_merge(jbeam, d, jnp.asarray(nbrs))
    want_hops = hops.numpy() + active.sum(1)
    want_counts = counts.numpy() + (nbrs >= 0).sum(1)
    limit = sp.ef if term == "ef" else sp.k
    want_uns = int(np.any(~np.asarray(jbeam.expanded)[:, :limit], axis=1).sum())

    _step(g, q_ext, bias, state, steps, sp, metric == 0)
    np.testing.assert_array_equal(beam.ids.numpy(), np.asarray(jbeam.ids))
    np.testing.assert_array_equal(beam.expanded.numpy(), np.asarray(jbeam.expanded))
    np.testing.assert_allclose(beam.dists.numpy(), np.asarray(jbeam.dists),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(hops.numpy(), want_hops)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert int(uns[steps + 1]) == want_uns


def _poison(d, keep, how, rng):
    bad = torch.from_numpy(rng.normal(size=tuple(d.shape)).astype(np.float32))
    poison = torch.full_like(d, float("nan")) if how == "nan" else bad * 100
    return torch.where(keep, d, poison)


def _assert_merges_equal(beam, d, nbrs, keep, how, rng):
    """beam_merge with the dropped lanes' distances poisoned equals the
    clean merge bit for bit, in the port and in the JAX package."""
    poisoned = _poison(d, keep, how, rng)
    want = tb.beam_merge(beam, d, nbrs)
    got = tb.beam_merge(beam, poisoned, nbrs)
    jgot = jb.beam_merge(jb.Beam(*(jnp.asarray(c.numpy()) for c in beam)),
                         jnp.asarray(poisoned.numpy()), jnp.asarray(nbrs.numpy()))
    for w, g, j in zip(want, got, jgot):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))
        np.testing.assert_array_equal(_bits(j), _bits(w.numpy()))


@pytest.mark.parametrize("how", ["nan", "random"])
@pytest.mark.parametrize("frontier,steps", [(1, 4), (4, 0), (4, 3), (8, 2)])
def test_dropped_lanes_never_reach_the_merge_on_a_search(case, frontier, steps, how):
    ds, graph = case
    sp = SearchParams(k=10, ef=32, frontier=frontier).resolved()
    g, q_ext, bias, state = _start(graph, ds.queries, sp, "f32", 0, steps)
    beam = state[0]
    slots, active, nbrs = bs.frontier_lists(beam, g.neighbors0, frontier)
    marked = tb.beam_mark_expanded(beam, slots, active)
    d = gather_score(g.vectors_ext, q_ext, bias, nbrs)
    keep = bs.kept_lanes(marked.ids, nbrs)
    valid = nbrs >= 0
    assert 0 < int(keep.sum()) < int(valid.sum())  # the search has duplicates
    _assert_merges_equal(marked, d, nbrs, keep, how, np.random.default_rng(frontier))


@pytest.mark.parametrize("how", ["nan", "random"])
@pytest.mark.parametrize("ef,K,n_ids", [(8, 16, 12), (16, 64, 40), (32, 128, 30)])
def test_dropped_lanes_never_reach_the_merge_on_random_lanes(ef, K, n_ids, how):
    """Random beams and lanes crowded with repeats, pads and ids of the
    beam; every copy of an id scores alike (a per-id table, as one row of
    one query does), with many equal and signed-zero distances."""
    rng = np.random.default_rng(ef + K)
    B = 24
    table = (rng.integers(-3, 4, size=(B, n_ids)) / 2.0).astype(np.float32)
    table[table == 0] = -0.0
    beam = tb.beam_init(B, ef)
    rows = np.arange(B)[:, None]
    for _ in range(3):
        ids = rng.integers(-1, n_ids, size=(B, K)).astype(np.int32)
        d = torch.from_numpy(table[rows, np.maximum(ids, 0)])
        beam = tb.beam_merge(beam, d, torch.from_numpy(ids))
        slots, _, active = tb.beam_frontier_multi(beam, 2)
        beam = tb.beam_mark_expanded(beam, slots, active)
    ids = rng.integers(-1, n_ids, size=(B, K)).astype(np.int32)
    nbrs = torch.from_numpy(ids)
    d = torch.from_numpy(table[rows, np.maximum(ids, 0)])
    keep = bs.kept_lanes(beam.ids, nbrs)
    _assert_merges_equal(beam, d, nbrs, keep, how, rng)


def test_kept_lanes_is_first_new_copy():
    rng = np.random.default_rng(5)
    beam_ids = torch.from_numpy(np.array(
        [[4, 9, 2, -1, -1], [7, 1, 3, 8, 0]], dtype=np.int32))
    lanes = torch.from_numpy(rng.integers(-1, 12, size=(2, 30)).astype(np.int32))
    got = bs.kept_lanes(beam_ids, lanes).tolist()
    for b in range(2):
        seen = set(beam_ids[b].tolist())
        for k, i in enumerate(lanes[b].tolist()):
            want = i >= 0 and i not in seen
            seen.add(i)
            assert got[b][k] == want, (b, k, i)


@pytest.mark.parametrize("term", ["ef", "k"])
@pytest.mark.parametrize("every,max_steps", [(2, 0), (4, 0), (5, 0), (4, 3), (4, 6)])
def test_gated_loop_equals_per_step_loop(case, term, every, max_steps):
    ds, graph = case
    g = th.device_graph(PortGraph.from_fields(graph), rows="f32", device="cpu")
    q_ext, bias = th._extend_query(torch.from_numpy(ds.queries), 0)
    sp = SearchParams(k=10, ef=32, frontier=4, term=term,
                      max_steps=max_steps).resolved()
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, True)
    one = th._beam_search_l0_seeded(g, q_ext, bias, seed_ids, seed_d, sp,
                                    check_every=1)
    few = th._beam_search_l0_seeded(g, q_ext, bias, seed_ids, seed_d, sp,
                                    check_every=every)
    for a, b in zip(one[0], few[0]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    np.testing.assert_array_equal(one[1].numpy(), few[1].numpy())
    np.testing.assert_array_equal(one[2].numpy(), few[2].numpy())
    assert one[3] == few[3] > 0
    if max_steps:  # the cap cuts the search short, or the search ends first
        free = SearchParams(k=10, ef=32, frontier=4, term=term).resolved()
        natural = th._beam_search_l0_seeded(g, q_ext, bias, seed_ids, seed_d,
                                            free, check_every=1)[3]
        assert one[3] == min(max_steps, natural)


def test_a_gated_step_changes_nothing(case):
    ds, graph = case
    sp = SearchParams(k=10, ef=32, frontier=4).resolved()
    g, q_ext, bias, state = _start(graph, ds.queries, sp, "f32", 0, 1)
    state[3][1] = 0
    before = [tb.Beam(*(c.clone() for c in state[0]))] + [x.clone() for x in state[1:]]
    _step(g, q_ext, bias, state, 1, sp, True)
    for a, b in zip(state[0], before[0]):
        assert torch.equal(a, b)
    for a, b in zip(state[1:], before[1:]):
        assert torch.equal(a, b)


def test_cpu_step_is_the_plain_step(case):
    """On the CPU ``beam_step`` runs ``beam_step_ref`` and launches nothing."""
    ds, graph = case
    sp = SearchParams(k=10, ef=32, frontier=4).resolved()
    g, q_ext, bias, a = _start(graph, ds.queries, sp, "bf16", 0, 2)
    b = [tb.Beam(*(c.clone() for c in a[0]))] + [x.clone() for x in a[1:]]
    launches = bs.beam_step.launches
    _step(g, q_ext, bias, a, 2, sp, True)
    _step(g, q_ext, bias, b, 2, sp, True, fn=bs.beam_step_ref)
    assert bs.beam_step.launches == launches
    for x, y in zip(list(a[0]) + a[1:], list(b[0]) + b[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["t", "k", "term", "frontier", "hops_dtype",
                                 "beam_shape", "lists_dtype", "scl_on_f32"])
def test_beam_step_rejects_bad_inputs(case, bad):
    ds, graph = case
    sp = SearchParams(k=10, ef=32, frontier=4).resolved()
    g, q_ext, bias, (beam, hops, counts, uns) = _start(
        graph, ds.queries, sp, "f32", 0, 0)
    kw = dict(frontier=4, k=10, term="ef", l2=True)
    nb, t = g.neighbors0, 0
    if bad == "t":
        t = sp.max_steps
    elif bad in ("k", "term", "frontier"):
        kw[bad] = {"k": 33, "term": "all", "frontier": 0}[bad]
    elif bad == "hops_dtype":
        hops = hops.long()
    elif bad == "beam_shape":
        beam = beam._replace(dists=beam.dists[:, :-1].contiguous())
    elif bad == "lists_dtype":
        nb = nb.long()
    elif bad == "scl_on_f32":
        kw["row_scl"] = torch.ones(g.vectors_ext.shape[0])
    with pytest.raises((ValueError, TypeError)):
        bs.beam_step(g.vectors_ext, nb, q_ext, bias, beam, hops, counts, uns, t,
                     **kw)


@pytest.mark.parametrize("bad_id", [-2, 3000])
def test_uploads_reject_lists_outside_the_table(case, bad_id):
    _, graph = case
    port = PortGraph.from_fields(graph)
    port.neighbors0 = port.neighbors0.copy()
    port.neighbors0[7, 0] = bad_id
    with pytest.raises(ValueError, match="neighbors0"):
        th.device_graph(port, device="cpu")
    jg, top = jh.device_graph(graph)
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in jg._asdict().items()}
    arrays["neighbors0"] = arrays["neighbors0"].copy()
    arrays["neighbors0"].reshape(-1, 16)[7, 0] = bad_id
    with pytest.raises(ValueError, match="neighbors0"):
        device_graph_from_jax(arrays, top_level=top, nbr_width=16, device="cpu")
