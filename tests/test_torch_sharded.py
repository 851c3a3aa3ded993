"""The port's sharded HNSW search (shine_tpu_torch.parallel.sharded) against
shine_tpu.parallel.sharded on one graph, built once per module with one
thread. The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``; the port on a CPU mesh of the same shard count.

Integer rows (small integers: every product and sum is exact in f32) must
agree bit for bit: ids, distances, the hop counts and the integer counters
(cache hits and misses, compact-exchange rounds and lanes); the wire-byte
counter, an f32 accumulator in JAX, within rtol 1e-6. Gaussian rows: ids
on >= 99.9% of slots and distances within ROADMAP C5's HNSW tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph import build_graph
from shine_tpu.io import recall_at_k, synthetic_dataset
from shine_tpu.io.skew import skewed_workload
from shine_tpu.parallel import ShardedIndex as JIndex
from shine_tpu.parallel import shard_mesh as jax_mesh
from shine_tpu.parallel import sharded as js
from shine_tpu.parallel.mesh import SHARD_AXIS
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.config import SearchParams as PortSP
from shine_tpu_torch.convert import replica_from_jax, sharded_graph_from_jax
from shine_tpu_torch.graph.soa import GraphSoA as PortGraph
from shine_tpu_torch.parallel import ShardedIndex, shard_mesh
from shine_tpu_torch.parallel import sharded as ts

MIN_AGREE = 0.999  # the bar of tests/test_sharded.py
RTOL, ATOL = 1e-5, 5e-4  # C5's HNSW distance tolerance
BYTES_RTOL = 1e-6


def _int_set(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def gauss():
    ds = synthetic_dataset(n=4000, dim=32, num_queries=128, seed=11)
    graph = build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=1)
    return ds.queries, graph, PortGraph.from_fields(graph), ds.ground_truth


@pytest.fixture(scope="module")
def ints():
    base, queries = _int_set(4000, 32, 128, 7)
    graph = build_graph(base, HNSWParams(M=16, ef_construction=100), threads=1)
    return queries, graph, PortGraph.from_fields(graph), None


def _sp(cls, spkw):
    return cls(k=10, ef=48, **spkw)


def _serve_both(fixture, S, kw, spkw, *, batch=64, queries=None, warm=False):
    q, graph, pgraph, _ = fixture
    q = q if queries is None else queries
    j = JIndex(graph, jax_mesh(S), **kw)
    t = ShardedIndex(pgraph, shard_mesh(S, device="cpu"), **kw)
    if warm:
        j.warm(q[:batch], _sp(SearchParams, spkw), batch_size=batch)
        t.warm(q[:batch], _sp(PortSP, spkw), batch_size=batch)
    ji, jd = j.search(q, _sp(SearchParams, spkw), batch_size=batch)
    ti, td = t.search(q, _sp(PortSP, spkw), batch_size=batch)
    return (j, ji, jd), (t, ti, td)


def _counters(idx):
    return {k: getattr(idx, k) for k in ("last_hops", "cache_hits",
                                         "cache_misses", "rpc_rounds",
                                         "ici_lanes", "refreshes")
            if hasattr(idx, k)}


def _assert_counters(j, t):
    assert _counters(t) == _counters(j)
    np.testing.assert_allclose(t.ici_bytes, j.ici_bytes, rtol=BYTES_RTOL)


# (S, index kwargs, search kwargs, warm-up pass)
INT_CASES = {
    "s2_dense": (2, {}, {}, False),
    "s4_compact": (4, {}, {"exchange": "compact"}, False),
    "s8_dense": (8, {}, {}, False),
    "s8_compact_cache": (8, {"cache_capacity": 512}, {"exchange": "compact"}, False),
    "s4_bf16_cache": (4, {"cache_capacity": 512, "rows": "bf16"}, {}, False),
    "s4_bf16_compact_descent": (4, {"rows": "bf16"},
                                {"exchange": "compact", "entry_mode": "descent"},
                                False),
    "s2_descent": (2, {}, {"entry_mode": "descent"}, False),
    "s4_adaptive_cache_r1": (4, {"cache_capacity": 512, "adaptive_cache": True,
                                 "refresh_every": 1}, {"exchange": "compact"}, False),
    "s4_adaptive_cache_r2_warm": (4, {"cache_capacity": 384, "adaptive_cache": True,
                                      "refresh_every": 2}, {}, True),
    "s4_routing": (4, {"routing": True}, {}, False),
    "s8_adaptive_routing_cache": (8, {"routing": "adaptive", "cache_capacity": 256},
                                  {"exchange": "compact"}, False),
    "s4_overflow_rounds": (4, {}, {"exchange": "compact", "exchange_slack": 0.1},
                           False),
    "s4_slack_ladder_routing": (4, {"routing": True},
                                {"exchange": "compact", "adaptive_slack": True},
                                False),
}


@pytest.mark.parametrize("case", list(INT_CASES))
def test_integer_rows_bit_for_bit(ints, case):
    S, kw, spkw, warm = INT_CASES[case]
    (j, ji, jd), (t, ti, td) = _serve_both(ints, S, kw, spkw, warm=warm)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
    _assert_counters(j, t)
    if "exchange_slack" in spkw:
        assert t.rpc_rounds > 0
    if spkw.get("adaptive_slack"):
        assert len(t._slack_ctl.samples) == min(len(ts.SlackController.LADDER),
                                                t.batches)


def test_integer_rows_every_route_same_bits(ints):
    """On the CPU too, the routes of one graph give one answer: S, the
    exchange, the replica and the routing move no bit (integer rows; on
    the card the Gaussian rows as well, tests/test_torch_kernel.py)."""
    q, _, pgraph, _ = ints
    sp = PortSP(k=10, ef=48)
    ref_i, ref_d = ShardedIndex(pgraph, shard_mesh(1, device="cpu")).search(
        q, sp, batch_size=64)
    for S, kw, spkw in [(2, {}, {"exchange": "compact"}),
                        (8, {"cache_capacity": 700, "routing": "adaptive"}, {})]:
        idx = ShardedIndex(pgraph, shard_mesh(S, device="cpu"), **kw)
        ids, dd = idx.search(q, PortSP(k=10, ef=48, **spkw), batch_size=64)
        np.testing.assert_array_equal(ids, ref_i)
        np.testing.assert_array_equal(dd.view(np.int32), ref_d.view(np.int32))


GAUSS_CASES = {
    "s4_dense": (4, {}, {}),
    "s8_compact_cache": (8, {"cache_capacity": 1024}, {"exchange": "compact"}),
    "s4_bf16": (4, {"rows": "bf16"}, {}),
    "s2_descent": (2, {}, {"entry_mode": "descent"}),
    "s4_adaptive_routing": (4, {"routing": "adaptive"}, {}),
}


@pytest.mark.parametrize("case", list(GAUSS_CASES))
def test_gaussian_rows_within_tolerance(gauss, case):
    S, kw, spkw = GAUSS_CASES[case]
    (j, ji, jd), (t, ti, td) = _serve_both(gauss, S, kw, spkw)
    assert (ti == ji).mean() >= MIN_AGREE
    qi, ai, bi = np.nonzero(ji[:, :, None] == ti[:, None, :])
    np.testing.assert_allclose(td[qi, bi], jd[qi, ai], rtol=RTOL, atol=ATOL)
    assert recall_at_k(ti, gauss[3], 10) > 0.95


def test_adaptive_routing_under_skew_matches_jax(gauss):
    """Zipf-skewed traffic moves the quotas off uniform; the batches and
    their per-slice loads are JAX's."""
    q, _, _, _ = gauss
    _, timed, _ = skewed_workload(q, total=384, alpha=1.25, seed=7)
    (j, ji, _), (t, ti, _) = _serve_both(gauss, 4, {"routing": "adaptive"}, {},
                                         queries=timed)
    assert (ti == ji).mean() >= MIN_AGREE
    jr, tr = j._adaptive_router, t._adaptive_router
    np.testing.assert_array_equal(np.stack(tr.quota_history),
                                  np.stack(jr.quota_history))
    assert (np.stack(tr.quota_history)[1:] != tr.quota_history[0]).any()
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))


def test_sharded_matches_single_card_port(gauss):
    q, _, pgraph, _ = gauss
    sp = PortSP(k=10, ef=64)
    single, _ = HNSWIndex(pgraph, device="cpu").search(q, sp, batch_size=64)
    sharded, _ = ShardedIndex(pgraph, shard_mesh(4, device="cpu")).search(
        q, sp, batch_size=64)
    assert (single == sharded).mean() >= MIN_AGREE


def test_batch_rounds_up_to_the_shard_grid(ints):
    """A batch that S does not divide is rounded up, the pad queries zero:
    JAX's batches of the same rounded size, tail included."""
    (j, ji, jd), (t, ti, td) = _serve_both(ints, 8, {}, {}, batch=50,
                                           queries=ints[0][:70])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
    assert t.batches == 2  # 70 queries in batches of 56
    _assert_counters(j, t)


def test_int8_rows_rejected(ints):
    with pytest.raises(ValueError, match="single-chip"):
        ShardedIndex(ints[2], shard_mesh(2, device="cpu"), rows="int8")


# --- one JAX layout served by both packages --------------------------------


def _np_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("S,rows", [(2, "f32"), (4, "bf16"), (8, "f32")])
def test_shard_graph_matches_jax_layout(ints, S, rows):
    _, graph, pgraph, _ = ints
    jg = _np_fields(js.shard_graph(graph, jax_mesh(S), rows=rows))
    mesh = shard_mesh(S, device="cpu")
    own = ts.shard_graph(pgraph, mesh, rows=rows)
    conv = sharded_graph_from_jax(jg, mesh=mesh)
    assert own.entry_u == conv.entry_u == int(jg["entry_u"])
    for f in ("vectors", "vec_sqnorms", "neighbors0", "upper_ids", "upper_vecs",
              "upper_sqnorms", "upper_adj"):
        for a, b in zip(getattr(own, f), getattr(conv, f)):
            assert a.dtype == b.dtype, f
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), f


@pytest.mark.parametrize("exchange", ["dense", "compact"])
def test_jax_layout_and_replica_served_by_port(ints, exchange):
    q, graph, _, _ = ints
    S, B = 4, 64
    j = JIndex(graph, jax_mesh(S), cache_capacity=600)
    sp = SearchParams(k=10, ef=48, exchange=exchange)
    ji, jd = j.search(q[:B], sp, batch_size=B)
    mesh = shard_mesh(S, device="cpu")
    g = sharded_graph_from_jax(_np_fields(j.device), mesh=mesh)
    rep = replica_from_jax(_np_fields(j.replica), mesh=mesh)
    res = ts.make_sharded_search(mesh, PortSP(k=10, ef=48, exchange=exchange),
                                 graph.params.metric_id)(
        g, torch.from_numpy(q[:B]), rep)
    np.testing.assert_array_equal(torch.cat(res.ids).numpy(), ji)
    np.testing.assert_array_equal(torch.cat(res.dists).numpy().view(np.int32),
                                  jd.view(np.int32))
    assert sum(int(h.sum()) for h in res.cache_hits) == j.cache_hits
    assert res.rpc_rounds == j.rpc_rounds
    assert res.ici_lanes == j.ici_lanes


# --- the compact exchange's primitive ---------------------------------------

RPC_S, RPS = 4, 100  # tests/test_owner_rpc.py's hand-counted case


def _rpc_ids(my):
    dest = (my + 1) % RPC_S
    return np.concatenate([dest * RPS + np.arange(3), my * RPS + 50 + np.arange(2),
                           np.full(3, -1)]).astype(np.int32)


def _jax_rpc(bucket):
    def spmd():
        my = jax.lax.axis_index(SHARD_AXIS)
        dest = (my + 1) % RPC_S
        ids = jnp.concatenate([dest * RPS + jnp.arange(3, dtype=jnp.int32),
                               my * RPS + 50 + jnp.arange(2, dtype=jnp.int32),
                               jnp.full((3,), -1, jnp.int32)])

        def payload(recv_ids, _aux):
            local = recv_ids - my * RPS
            ok = (recv_ids < 0) | ((local >= 0) & (local < RPS))
            val = jnp.where(recv_ids >= 0, 2.0 * recv_ids, jnp.float32(-7.0))
            return jnp.where(ok, val, jnp.float32(1e9))[..., None]

        out, rounds, lanes = js._owner_rpc(
            ids, jnp.arange(8, dtype=jnp.int32), payload, rows_per_shard=RPS,
            num_shards=RPC_S, bucket=bucket, width=1, dtype=jnp.float32,
            fill=jnp.inf)
        return out[:, 0], rounds, jax.lax.psum(lanes, SHARD_AXIS)

    fn = jax.jit(jax.shard_map(spmd, mesh=jax_mesh(RPC_S), in_specs=(),
                               out_specs=(P(SHARD_AXIS), P(), P()),
                               check_vma=False))
    out, rounds, lanes = fn()
    return np.asarray(out), int(rounds), int(lanes)


@pytest.mark.parametrize("bucket,want_rounds", [(8, 1), (2, 2)])
def test_owner_rpc_hand_counted_against_jax(bucket, want_rounds):
    mesh = shard_mesh(RPC_S, device="cpu")

    def payload(s, recv_ids, _aux):
        local = recv_ids - s * RPS
        ok = (recv_ids < 0) | ((local >= 0) & (local < RPS))
        val = torch.where(recv_ids >= 0, 2.0 * recv_ids, -7.0)
        return torch.where(ok, val, 1e9)[..., None].to(torch.float32)

    ids = [torch.from_numpy(_rpc_ids(s)) for s in range(RPC_S)]
    out, rounds, lanes = ts._owner_rpc(
        mesh, ids, [torch.arange(8, dtype=torch.int32)] * RPC_S, payload,
        rows_per_shard=RPS, bucket=bucket, width=1, dtype=torch.float32,
        fill=torch.inf)
    got = torch.cat([o[:, 0] for o in out]).numpy()
    want, j_rounds, j_lanes = _jax_rpc(bucket)
    np.testing.assert_array_equal(got, want)
    flat = np.concatenate([_rpc_ids(s) for s in range(RPC_S)])
    np.testing.assert_array_equal(got[flat >= 0], 2.0 * flat[flat >= 0])
    assert rounds == j_rounds == want_rounds
    assert mesh.host_sum(lanes) == j_lanes == 12


def test_rpc_bucket_matches_jax():
    for lanes in (4, 64, 100, 1000, 4096):
        for S in (1, 2, 4, 8):
            for slack in (0.1, 1.0, 1.5, 2.0):
                assert ts._rpc_bucket(lanes, S, slack) == js._rpc_bucket(
                    lanes, S, slack)
