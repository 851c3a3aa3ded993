"""The port's own graph, native builder, io and device rule against the JAX
package's: shine_tpu_torch.graph.soa.build_graph against
shine_tpu.graph.soa.build_graph (one thread, so both are deterministic),
checkpoints that load in either package, the synthetic generator and the
numpy oracle, and entry points that refuse to run without a CUDA card
unless asked for the CPU."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams as JParams
from shine_tpu.graph.soa import build_graph as j_build_graph
from shine_tpu.io import checkpoint as j_ckpt
from shine_tpu.io import recall as j_recall
from shine_tpu.io.datasets import synthetic_dataset as j_synthetic_dataset
from shine_tpu.models import hnsw as jh
from shine_tpu_torch import (
    FastFlatIndex,
    FlatIndex,
    HNSWIndex,
    HNSWParams,
    SearchParams,
    device_graph_from_jax,
    fastflat_from_jax,
    native,
)
from shine_tpu_torch import config as tconfig
from shine_tpu_torch.graph.soa import GraphSoA, build_graph
from shine_tpu_torch.io import (
    brute_force_knn,
    load_graph,
    recall_at_k,
    save_graph,
    synthetic_dataset,
)
from shine_tpu_torch.models import hnsw as th

_FIELDS = ("vectors", "levels", "neighbors0", "upper_row", "upper_neighbors")


@pytest.fixture(scope="module")
def small():
    return synthetic_dataset(n=1500, dim=16, num_queries=32, seed=4)


def _assert_same_graph(a, b):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.entry_point, a.top_level) == (b.entry_point, b.top_level)
    assert (a.params.M, a.params.ef_construction, a.params.metric,
            a.params.seed) == (b.params.M, b.params.ef_construction,
                               b.params.metric, b.params.seed)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_graph_matches_jax_package(small, metric):
    kw = dict(M=8, ef_construction=48, metric=metric, seed=3)
    port = build_graph(small.base, HNSWParams(**kw), threads=1)
    jax_side = j_build_graph(small.base, JParams(**kw), threads=1)
    _assert_same_graph(port, jax_side)
    assert isinstance(port.params, tconfig.HNSWParams)


def test_multithreaded_build_is_exact_on_tiny_graph():
    """ROADMAP C1: a new vertex connects itself into other lists only once
    its own lists are all written, so no other thread finds it with empty
    lists or loses an edge into them, and every build on 8 threads stays
    navigable: ef >= n finds the exact top-10 on each of 20 builds."""
    ds = synthetic_dataset(n=200, dim=8, num_queries=32, seed=1)
    gt_ids, _ = brute_force_knn(ds.base, ds.queries, 10)
    inexact = []
    for i in range(20):
        g = build_graph(ds.base, HNSWParams(M=8, ef_construction=64), threads=8)
        ids, _ = HNSWIndex(g, device="cpu").search(
            ds.queries, SearchParams(k=10, ef=256), batch_size=32)
        if recall_at_k(ids, gt_ids, 10) != 1.0:
            inexact.append(i)
    assert inexact == [], f"{len(inexact)} of 20 builds are inexact"


def _unreachable_level0(g) -> np.ndarray:
    """The vertices that level 0 does not reach from the entry point."""
    seen = np.zeros(len(g.neighbors0), bool)
    seen[g.entry_point] = True
    frontier = np.array([g.entry_point])
    while len(frontier):
        nxt = g.neighbors0[frontier].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        frontier = nxt[~seen[nxt]]
        seen[frontier] = True
    return np.nonzero(~seen)[0]


def test_multithreaded_build_reaches_every_vertex():
    """ROADMAP C1's remnant: on 8 threads a vertex could lose its last
    level-0 in-edge to its neighbours' shrink-if-full pruning (161 of 3,000
    seeded builds of 200 rows); the build's repair pass links each such
    vertex from its nearest reachable one, so on every one of 300 builds
    level 0 reaches every vertex from the entry point."""
    bad = []
    for i in range(300):
        ds = synthetic_dataset(n=200, dim=8, num_queries=1, seed=i % 50,
                               compute_gt=False)
        g = build_graph(ds.base, HNSWParams(M=8, ef_construction=64, seed=i),
                        threads=8)
        if len(_unreachable_level0(g)):
            bad.append(i)
    assert bad == [], f"{len(bad)} of 300 builds left a vertex unreachable"


def test_level0_repair_keeps_what_a_replaced_edge_reached():
    """ROADMAP C1's repair, its full-list branch: every reachable list is
    full, so the unreachable vertex v takes a slot of its nearest reachable
    vertex u. u's farthest neighbour w is reached only through u (w and x
    link to each other and nothing else reaches them), so that edge must
    stay: the repair gives up u's edge to the entry point instead, and
    level 0 then reaches every vertex."""
    u, w, x, v = 4, 5, 6, 7
    vecs = np.array([[0, 0], [1, 0], [2, 0], [3, 0], [9, 0], [-10, 5], [-10, 6],
                     [10, 0]], np.float32)
    lists = np.array([[1, 2, 3, u], [0, 2, 3, u], [0, 1, 3, u], [0, 1, 2, u],
                      [w, 0, 1, 3], [x, 0, 1, 2], [w, 0, 1, 2], [0, 1, 2, 3]], np.int32)
    g = SimpleNamespace(neighbors0=lists, entry_point=0)
    assert list(_unreachable_level0(g)) == [v]
    _, fixed, repaired = native.repair_level0(vecs, np.zeros(8, np.int32), lists, 0,
                                              efc=16)
    assert repaired == 1
    assert list(fixed[u]) == [w, v, 1, 3]
    np.testing.assert_array_equal(np.delete(fixed, u, 0), np.delete(lists, u, 0))
    g.neighbors0 = fixed
    assert len(_unreachable_level0(g)) == 0


def test_native_library_builds_under_build_dir():
    path = native.lib_path()
    native.load()
    assert os.path.exists(path)
    assert os.sep.join(["build", "shine_tpu_torch"]) in path
    assert not path.startswith(os.path.dirname(native.__file__))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_round_trips_between_packages(small, tmp_path, direction):
    graph = build_graph(small.base, HNSWParams(M=8, ef_construction=32),
                        threads=1)
    path = str(tmp_path / "g.npz")
    if direction == "port_to_jax":
        save_graph(graph, path)
        loaded = j_ckpt.load_graph(path)
    else:
        j_ckpt.save_graph(j_build_graph(small.base, JParams(M=8, ef_construction=32),
                                        threads=1), path)
        loaded = load_graph(path)
        assert isinstance(loaded, GraphSoA)
    _assert_same_graph(loaded, graph)


def test_from_fields_copies_a_jax_graph(small):
    jg = j_build_graph(small.base, JParams(M=8, ef_construction=32), threads=1)
    tg = GraphSoA.from_fields(jg)
    _assert_same_graph(tg, jg)
    assert isinstance(tg.params, tconfig.HNSWParams)
    assert tg.n == jg.n and tg.dim == jg.dim and tg.level_cap == jg.level_cap


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_io_matches_jax_package(metric):
    a = synthetic_dataset(n=700, dim=12, num_queries=20, seed=9, metric=metric)
    b = j_synthetic_dataset(n=700, dim=12, num_queries=20, seed=9, metric=metric)
    np.testing.assert_array_equal(a.base, b.base)
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(a.ground_truth, b.ground_truth)
    got = brute_force_knn(a.base, a.queries, 7, metric=metric, chunk=300)
    want = j_recall.brute_force_knn(a.base, a.queries, 7, metric=metric, chunk=300)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    noisy = np.roll(a.ground_truth[:, :10], 1, axis=0)
    assert recall_at_k(noisy, a.ground_truth, 10) == j_recall.recall_at_k(
        noisy, a.ground_truth, 10)


def test_config_matches_jax_package():
    from shine_tpu import config as jc

    assert (tconfig.METRIC_L2, tconfig.METRIC_IP) == (jc.METRIC_L2, jc.METRIC_IP)
    for m in ("l2", "IP", 0, 1):
        assert tconfig.metric_id(m) == jc.metric_id(m)
    for bad in ("cos", 2):
        with pytest.raises(ValueError):
            tconfig.metric_id(bad)
    sp, jsp = SearchParams(ef=40, frontier=3), jc.SearchParams(ef=40, frontier=3)
    assert sp.resolved().max_steps == jsp.resolved().max_steps
    import dataclasses

    assert ([f.name for f in dataclasses.fields(SearchParams)]
            == [f.name for f in dataclasses.fields(jc.SearchParams)])
    assert SearchParams().__dict__ == jc.SearchParams().__dict__
    assert HNSWParams().__dict__ == jc.HNSWParams().__dict__
    assert HNSWParams(M=12).m_L == jc.HNSWParams(M=12).m_L


@pytest.mark.parametrize("entry", ["HNSWIndex", "HNSWIndex.build", "device_graph",
                                   "device_graph_from_jax", "FlatIndex",
                                   "FastFlatIndex", "fastflat_from_jax"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(small, monkeypatch,
                                                           entry):
    graph = build_graph(small.base, HNSWParams(M=8, ef_construction=32),
                        threads=1)
    jg, top = jh.device_graph(j_build_graph(small.base, JParams(M=8, ef_construction=32),
                                            threads=1))
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in jg._asdict().items()}
    fast_arrays = {"ext": np.zeros((4096, 128), np.float32)}
    calls = {
        "HNSWIndex": lambda **kw: HNSWIndex(graph, **kw),
        "HNSWIndex.build": lambda **kw: HNSWIndex.build(
            small.base[:200], HNSWParams(M=4, ef_construction=16), threads=1, **kw),
        "device_graph": lambda **kw: th.device_graph(graph, **kw),
        "device_graph_from_jax": lambda **kw: device_graph_from_jax(
            arrays, top_level=top, nbr_width=16, **kw),
        "FlatIndex": lambda **kw: FlatIndex(small.base, **kw),
        "FastFlatIndex": lambda **kw: FastFlatIndex(small.base, **kw),
        "fastflat_from_jax": lambda **kw: fastflat_from_jax(
            fast_arrays, n=10, dim=16, metric="l2", **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry](device="cuda")
    made = calls[entry](device="cpu")
    assert made is not None
