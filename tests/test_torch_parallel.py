"""The host pieces of the port's sharded paths against the JAX package's:
the shard mesh's collectives, placement (k-means, balanced assignment,
``Placement``), the query routers, the hot-vertex replica's selection,
build and lookup, the access counter, ``ShardedFlatIndex`` and the sharded
checkpoints. The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``, the port on a CPU mesh of as many shards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams
from shine_tpu.graph import build_graph
from shine_tpu.io import checkpoint as jck
from shine_tpu.io import synthetic_dataset
from shine_tpu.parallel import ShardedFlatIndex as JFlat
from shine_tpu.parallel import hot_cache as jhc
from shine_tpu.parallel import placement as jpl
from shine_tpu.parallel import router as jrt
from shine_tpu.parallel import shard_mesh as jax_mesh
from shine_tpu_torch.config import HNSWParams as PortParams
from shine_tpu_torch.graph.soa import GraphSoA as PortGraph
from shine_tpu_torch.io import checkpoint as tck
from shine_tpu_torch.parallel import ShardedFlatIndex, shard_mesh
from shine_tpu_torch.parallel import hot_cache as thc
from shine_tpu_torch.parallel import placement as tpl
from shine_tpu_torch.parallel import router as trt

# centroids: Lloyd's sums add in other orders in the two packages
CENT_ATOL = 1e-4
# ShardedFlatIndex distances: the two frameworks sum |q|^2 - 2 q.v + |v|^2
# in other orders (ROADMAP C5)
FLAT_RTOL, FLAT_ATOL = 1e-5, 5e-4


@pytest.fixture(scope="module")
def case():
    ds = synthetic_dataset(n=4000, dim=32, num_queries=128, seed=11)
    graph = build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=1)
    return ds, graph, PortGraph.from_fields(graph)


# --- the mesh --------------------------------------------------------------


def test_mesh_collectives_follow_their_definitions():
    S = 4
    mesh = shard_mesh(S, device="cpu")
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.integers(-9, 9, size=(S * 3, 2)).astype(np.int32))
             for _ in range(S)]
    full = torch.cat(parts)
    for got in mesh.all_gather(parts):
        assert torch.equal(got, full)
    total = sum(p.to(torch.int64) for p in parts).to(torch.int32)
    for got in mesh.psum(parts):
        assert torch.equal(got, total)
    for r, got in enumerate(mesh.psum_scatter(parts)):
        assert torch.equal(got, total[r * 3:(r + 1) * 3])
    blocks = [p.reshape(S, 3, 2) for p in parts]
    for j, got in enumerate(mesh.all_to_all(blocks)):
        assert torch.equal(got, torch.stack([b[j] for b in blocks]))
    assert mesh.host_sum([torch.tensor(i) for i in range(S)]) == 6
    assert mesh.readbacks == 1
    assert [t.data_ptr() for t in mesh.replicate(full)] == [full.data_ptr()] * S


def test_mesh_devices_and_refusals(monkeypatch):
    assert shard_mesh(3, device="cpu").describe() == ["cpu"] * 3
    assert shard_mesh(2, devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        shard_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError):
        shard_mesh(2, device="cpu").psum([torch.zeros(1)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        shard_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        shard_mesh(2, devices=["cuda:0", "cuda:0"])


# --- placement and routing -------------------------------------------------


@pytest.mark.parametrize("n,k,cap", [(60, 4, 15), (61, 5, 13), (200, 8, 30)])
def test_capacity_assign_matches_jax(n, k, cap):
    d = np.random.default_rng(n).random((n, k)).astype(np.float32)
    np.testing.assert_array_equal(tpl.capacity_assign(d, cap),
                                  jpl.capacity_assign(d, cap))


@pytest.mark.parametrize("k,balanced", [(4, True), (8, True), (4, False)])
def test_kmeans_matches_jax(case, k, balanced):
    _, graph, _ = case
    pts = graph.vectors[:600]
    jc, ja = jpl.kmeans(jnp.asarray(pts), k=k, iters=20, balanced=balanced)
    tc, ta = tpl.kmeans(pts, k=k, iters=20, balanced=balanced)
    np.testing.assert_allclose(tc, np.asarray(jc), atol=CENT_ATOL)
    np.testing.assert_array_equal(ta, np.asarray(ja))


def test_kmeans_first_centre_is_jax_draw(case):
    import jax

    _, graph, _ = case
    pts = graph.vectors[:600]
    want = np.asarray(jpl._init_centroids(jnp.asarray(pts), 3, 1234))
    n = pts.shape[0]
    first = int(jax.random.randint(jax.random.PRNGKey(1234), (), 0, n))
    got = tpl._init_centroids(torch.from_numpy(pts), 3, 1234, first=first).numpy()
    np.testing.assert_array_equal(got, want)
    from shine_tpu_torch.ops import threefry
    assert int(threefry.randint(threefry.prng_key(1234), (), 0, n)) == first


@pytest.fixture(scope="module")
def placements(case):
    _, graph, pgraph = case
    return {S: (jpl.Placement(graph, S), tpl.Placement(pgraph, S))
            for S in (2, 4, 8)}


@pytest.mark.parametrize("S", [2, 4, 8])
def test_placement_matches_jax(case, placements, S):
    ds, _, _ = case
    jp, tp = placements[S]
    np.testing.assert_allclose(tp.centroids, np.asarray(jp.centroids),
                               atol=CENT_ATOL)
    np.testing.assert_array_equal(tp.shard_of(ds.queries), jp.shard_of(ds.queries))
    np.testing.assert_array_equal(tp.closest_shards(ds.queries),
                                  jp.closest_shards(ds.queries))


@pytest.mark.parametrize("S,batch", [(4, 32), (8, 64), (2, 48)])
def test_query_router_plan_matches_jax(case, placements, S, batch):
    ds, _, _ = case
    jp, tp = placements[S]
    jperm, jused = jrt.QueryRouter(jp, batch_size=batch).plan(ds.queries)
    tperm, tused = trt.QueryRouter(tp, batch_size=batch).plan(ds.queries)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tused, jused)
    routed, valid = trt.QueryRouter.apply(ds.queries, tperm)
    back = trt.QueryRouter.unpermute(routed, tperm, len(ds.queries))
    np.testing.assert_array_equal(back, ds.queries)


def test_adaptive_router_matches_jax(case, placements):
    ds, _, _ = case
    jp, tp = placements[4]
    ja = jrt.AdaptiveQueryRouter(jp, batch_size=32)
    ta = trt.AdaptiveQueryRouter(tp, batch_size=32)
    ja.start(ds.queries)
    ta.start(ds.queries)
    rng = np.random.default_rng(3)
    while (jb := ja.next_batch()) is not None:
        tb = ta.next_batch()
        np.testing.assert_array_equal(tb, jb)
        hops = rng.integers(0, 50, size=32)
        ja.observe(hops)
        ta.observe(hops)
    assert ta.next_batch() is None
    np.testing.assert_array_equal(np.stack(ta.quota_history),
                                  np.stack(ja.quota_history))


# --- the hot-vertex replica ------------------------------------------------


@pytest.mark.parametrize("with_counts", [False, True])
def test_select_hot_ids_matches_jax(case, with_counts):
    _, graph, pgraph = case
    counts = (np.random.default_rng(1).integers(0, 5, graph.n).astype(np.float64)
              if with_counts else None)
    np.testing.assert_array_equal(thc.select_hot_ids(pgraph, 300, counts),
                                  jhc.select_hot_ids(graph, 300, counts))


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_build_replica_and_lookup_match_jax(case, rows):
    _, graph, pgraph = case
    hot = jhc.select_hot_ids(graph, 256)
    jr = jhc.build_replica(graph, hot, rows=rows)
    tr = thc.build_replica(pgraph, hot, rows=rows, device="cpu")
    np.testing.assert_array_equal(tr.hot_ids.numpy(), np.asarray(jr.hot_ids))
    want_v = np.asarray(jr.hot_vecs)
    got_v = tr.hot_vecs
    if rows == "bf16":  # compare the bits
        want_v = want_v.view(np.int16)
        got_v = got_v.view(torch.int16)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(tr.hot_sq.numpy(), np.asarray(jr.hot_sq))
    np.testing.assert_array_equal(tr.hot_neighbors.numpy(),
                                  np.asarray(jr.hot_neighbors))
    probe = np.concatenate([hot[::7], np.arange(0, graph.n, 97, dtype=np.int32),
                            [-1, graph.n - 1, 5]]).astype(np.int32)[:80].reshape(2, -1)
    jrows, jhit = jhc.replica_lookup(jr, jnp.asarray(probe))
    trows, thit = thc.replica_lookup(tr, torch.from_numpy(probe))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))


def test_access_counter_matches_jax(case):
    _, graph, pgraph = case
    jc, tc = jhc.AccessCounter(graph.n), thc.AccessCounter(graph.n)
    rng = np.random.default_rng(4)
    hot = jhc.select_hot_ids(graph, 64)
    for _ in range(3):
        rc = rng.integers(0, 3, graph.n + 7).astype(np.float32)
        hc = rng.integers(0, 3, 64).astype(np.float32)
        jc.absorb(rc, hot, hc)
        tc.absorb(rc, hot, hc)
    np.testing.assert_array_equal(tc.counts, jc.counts)
    jr = jc.refresh(graph, 100)
    tr = tc.refresh(pgraph, 100, device="cpu")
    np.testing.assert_array_equal(tr.hot_ids.numpy(), np.asarray(jr.hot_ids))


# --- ShardedFlatIndex --------------------------------------------------------


@pytest.mark.parametrize("S,metric,use_bf16", [
    (2, "l2", True), (4, "l2", False), (8, "ip", True), (4, "ip", False),
])
def test_sharded_flat_matches_jax(S, metric, use_bf16):
    ds = synthetic_dataset(n=3000, dim=16, num_queries=70, seed=5, metric=metric)
    j = JFlat(ds.base, jax_mesh(S), metric=metric)
    t = ShardedFlatIndex(ds.base, shard_mesh(S, device="cpu"), metric=metric)
    ji, jd = j.search(ds.queries, 10, batch_size=32, use_bf16=use_bf16)
    ti, td = t.search(ds.queries, 10, batch_size=32, use_bf16=use_bf16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=FLAT_RTOL, atol=FLAT_ATOL)
    assert t.rows == j.rows
    assert t.cost_counters(70, 10, batch_size=32) == j.cost_counters(
        70, 10, batch_size=32)


# --- sharded checkpoints -----------------------------------------------------


def _same_graph(a, b) -> None:
    for f in ("vectors", "levels", "neighbors0", "upper_row", "upper_neighbors"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.entry_point, a.top_level) == (b.entry_point, b.top_level)
    assert a.params.M == b.params.M and a.params.metric == b.params.metric


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_checkpoints_across_packages(case, tmp_path, S):
    _, graph, pgraph = case
    jck.save_graph_sharded(graph, str(tmp_path / "jax"), S)
    _same_graph(tck.load_graph_sharded(str(tmp_path / "jax")), graph)
    tck.save_graph_sharded(pgraph, str(tmp_path / "port"), S)
    _same_graph(jck.load_graph_sharded(str(tmp_path / "port")), graph)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("metric,shards", [("l2", 1), ("ip", 8)])
def test_index_path_matches_jax(metric, shards):
    jp = HNSWParams(M=12, ef_construction=77, metric=metric)
    tp = PortParams(M=12, ef_construction=77, metric=metric)
    assert tck.index_path("/r", "sift", tp, shards) == jck.index_path(
        "/r", "sift", jp, shards)
