"""The port's cluster-sharded IVF (shine_tpu_torch.parallel.ivf_sharded)
against shine_tpu.parallel.ivf_sharded. The JAX index is built once a module
on 4 of the 8 virtual CPU devices of ``tests/conftest.py``; its layout is
carried over by ``convert.sharded_ivf_from_jax`` and served by both, so
that the search is held apart from the build.

Integer rows (every product and sum exact): ids and distances bit for bit
through the compact and dense probe lanes and the routed search, and the
counters equal (``rpc_rounds``, ``scanned_lanes``, the analytic costs).
Gaussian rows: ids on >= 99.9% of slots, distances within C5's tolerance.
The port's own build holds the JAX layout dealt as the JAX package deals
it, from the same seed (the port draws JAX's ids)."""

import jax
import numpy as np
import pytest
import torch

from shine_tpu.io import synthetic_dataset
from shine_tpu.parallel import shard_mesh as jax_mesh
from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex as JIVF
from shine_tpu_torch.convert import sharded_ivf_from_jax
from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.parallel import ShardedIVFIndex, shard_mesh

S, D = 4, 16
MIN_AGREE = 0.999
RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def _arrays(j) -> dict:
    return {"centroids": _np(j.centroids), "blocks": _np(j.blocks),
            "block_sq": _np(j.block_sq), "block_ids": _np(j.block_ids),
            "base": j.base}


@pytest.fixture(scope="module")
def ints():
    rng = np.random.default_rng(3)
    base = rng.integers(-8, 9, size=(8000, D)).astype(np.float32)
    q = rng.integers(-8, 9, size=(128, D)).astype(np.float32)
    j = JIVF(base, jax_mesh(S), seed=5)
    return base, q, j, sharded_ivf_from_jax(_arrays(j), metric="l2",
                                            mesh=shard_mesh(S, device="cpu"))


@pytest.mark.parametrize("lanes", ["compact", "dense"])
@pytest.mark.parametrize("probes", [4, 16])
def test_search_bit_for_bit_with_counters(ints, lanes, probes):
    _, q, j, t = ints
    j.rpc_rounds = j.scanned_lanes = t.rpc_rounds = t.scanned_lanes = 0
    ji, jd = j.search(q, 10, probes=probes, batch_size=64, probe_lanes=lanes)
    ti, td = t.search(q, 10, probes=probes, batch_size=64, probe_lanes=lanes)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), np.asarray(jd).view(np.int32))
    assert (t.rpc_rounds, t.scanned_lanes) == (j.rpc_rounds, j.scanned_lanes)
    assert t.scanned_lanes > 0


def test_compact_equals_dense_and_reads_once_a_round(ints):
    """The compact lanes give the dense scan's answer id for id; the loop
    reads the pending sum from the host once a round, plus the final check."""
    _, q, _, t = ints
    mesh = t.mesh
    t.rpc_rounds = 0
    r0 = mesh.readbacks
    ci, _ = t.search(q, 10, probes=16, batch_size=128)
    assert mesh.readbacks - r0 == t.rpc_rounds + 1
    di, _ = t.search(q, 10, probes=16, batch_size=128, probe_lanes="dense")
    np.testing.assert_array_equal(ci, di)


@pytest.mark.parametrize("knobs", [(8, 16, 32), (4, 8, 64)])
def test_search_routed_bit_for_bit(ints, knobs):
    _, q, j, t = ints
    p, P, T = knobs
    kw = dict(probes=p, shared=P, tile=T, batch_size=128)
    ji, jd = j.search_routed(q, 10, **kw)
    ti, td = t.search_routed(q, 10, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), np.asarray(jd).view(np.int32))


def test_cost_counters_match_jax(ints):
    _, _, j, t = ints
    assert t.cost_counters(1000, probes=16) == j.cost_counters(1000, probes=16)
    assert t.routed_cost_counters(1000, probes=8, shared=16, tile=32) == \
        j.routed_cost_counters(1000, probes=8, shared=16, tile=32)
    assert (t.C, t.C_loc, t.cap) == (j.C, j.C_loc, j.cap)


def test_gaussian_within_c5():
    ds = synthetic_dataset(n=8000, dim=D, num_queries=128, seed=9)
    j = JIVF(ds.base, jax_mesh(S), seed=7)
    t = sharded_ivf_from_jax(_arrays(j), metric="l2", mesh=shard_mesh(S, device="cpu"))
    ji, jd = j.search(ds.queries, 10, probes=8, batch_size=64)
    ti, td = t.search(ds.queries, 10, probes=8, batch_size=64)
    assert (ti == ji).mean() >= MIN_AGREE
    same = ti == ji
    np.testing.assert_allclose(td[same], np.asarray(jd)[same], rtol=RTOL, atol=ATOL)
    assert recall_at_k(ti, ds.ground_truth, 10) > 0.9


def test_port_build_deals_the_jax_layout(ints):
    """From the same seed (the farthest-point draw is JAX's), the port's
    own build lands on the JAX layout (C rounded to the mesh, clusters
    dealt s, s + S, ...) and serves the same ids."""
    base, q, j, _ = ints
    own = ShardedIVFIndex(base, shard_mesh(S, device="cpu"), seed=5)
    assert own.C % S == 0 and own.C == j.C
    ji, _ = j.search(q, 10, probes=8, batch_size=64)
    oi, _ = own.search(q, 10, probes=8, batch_size=64)
    assert (oi == ji).mean() >= MIN_AGREE
    for s in range(S):
        ids = own.block_ids[s]
        # shard s holds clusters s, s + S, ...: every real id once overall
        assert ids.shape[0] == own.C_loc
    real = np.sort(np.concatenate([x[x >= 0].numpy() for x in own.block_ids]))
    np.testing.assert_array_equal(real, np.arange(len(base)))


def test_rejects_a_layout_off_the_mesh():
    with pytest.raises(ValueError, match="multiple"):
        ShardedIVFIndex.from_parts(
            shard_mesh(S, device="cpu"), torch.zeros(6, D),
            torch.zeros((6, 4, D), dtype=torch.bfloat16), torch.zeros(6, 4),
            torch.zeros((6, 4), dtype=torch.int32), np.zeros((10, D), np.float32))
    with pytest.raises(ValueError, match="probe_lanes"):
        ShardedIVFIndex.from_parts(
            shard_mesh(S, device="cpu"), torch.zeros(8, D),
            torch.zeros((8, 4, D), dtype=torch.bfloat16), torch.zeros(8, 4),
            torch.zeros((8, 4), dtype=torch.int32), np.zeros((10, D), np.float32)
        ).search(np.zeros((2, D), np.float32), probe_lanes="sparse")
