"""The IVF family of the port (``shine_tpu_torch/models/ivf.py``: IVFIndex,
its host and device builds, the per-query and routed probe searches, the
spill) against the JAX package's, on the CPU.

Both packages serve one layout (``convert.ivf_from_jax`` of a JAX
``IVFData``): on Gaussian rows the ids agree in at least 99% of positions
and the distances within ``rtol=1e-5`` and 8 ulps of the largest
|q|^2 + |v|^2 where they agree (the two sum f32 products in other orders,
ROADMAP C5); on small-integer rows and
queries every product and sum is exact, and ids and distances are equal bit
for bit, ties included. The builds draw JAX's ids from the same seed (the
draws are held bit for bit): bit for bit on integer rows with the
centroids given, by tolerance from scratch. The rest are the JAX package's own invariants, on
the port alone. JAX runs its XLA functions on the CPU; IVF reaches no
Pallas kernel in either package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.models import ivf as jivf
from shine_tpu.parallel import placement as jpl
from shine_tpu_torch import IVFIndex, ivf_from_jax
from shine_tpu_torch.config import METRIC_IP, METRIC_L2
from shine_tpu_torch.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu_torch.models import ivf as tivf
from shine_tpu_torch.parallel import placement as tpl

RTOL = 1e-5
# L2 distances are differences of terms up to |q|^2 + |v|^2 (~1.5e3 at d=32,
# ~4e3 at d=128) that XLA and torch sum in other orders: a few ulps of the
# largest term (C5); ATOL_ULPS of it bound them
ATOL_ULPS = 8
MIN_OVERLAP = 0.99
MIN_SAME_CLUSTER = 0.99
CENT_ATOL = 1e-3  # k-means centroids after 20-25 Lloyd steps from one init
ROUTED = dict(p=8, shared=48, tile=32)
NQ_ROUTED = 192  # a multiple of the tile


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=6000, dim=32, num_queries=200, seed=13)


@pytest.fixture(scope="module")
def ds_ip():
    return synthetic_dataset(n=6000, dim=32, num_queries=200, seed=13, metric="ip")


@pytest.fixture(scope="module")
def jax_layouts(ds, ds_ip):
    """The JAX package's IVF indexes, L2 and IP (C=64, seed 7)."""
    return {"l2": (jivf.IVFIndex(ds.base, num_clusters=64, seed=7), ds),
            "ip": (jivf.IVFIndex(ds_ip.base, num_clusters=64, seed=7, metric="ip"),
                   ds_ip)}


@pytest.fixture(scope="module")
def port_idx(ds):
    """The port's own build (C=64, seed 7) for the invariants."""
    return IVFIndex(ds.base, num_clusters=64, seed=7, device="cpu")


def _arrays(data) -> dict:
    return {name: np.asarray(a) for name, a in zip(jivf.IVFData._fields, data)}


def _carried(jidx, metric: str) -> IVFIndex:
    return ivf_from_jax(_arrays(jidx.data), metric=metric, device="cpu")


def _jax_data(data: tivf.IVFData) -> jivf.IVFData:
    """A port layout as a JAX IVFData (bf16 blocks exact through f32)."""
    return jivf.IVFData(*(
        jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
        else jnp.asarray(t.numpy()) for t in data))


def _atol(base: np.ndarray, queries: np.ndarray) -> float:
    big = (base * base).sum(1).max() + (queries * queries).sum(1).max()
    return ATOL_ULPS * float(np.spacing(np.float32(big)))


def _assert_close(a_ids, a_d, b_ids, b_d, atol: float):
    same = np.asarray(a_ids) == np.asarray(b_ids)
    assert same.mean() >= MIN_OVERLAP, same.mean()
    np.testing.assert_allclose(np.asarray(a_d)[same], np.asarray(b_d)[same],
                               rtol=RTOL, atol=atol)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _jax_choice(n, m, seed):
    return torch.from_numpy(np.asarray(jax.random.choice(
        jax.random.PRNGKey(seed), n, (m,), replace=False)).astype(np.int64))


def _jax_first(n, seed):
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))


def _cluster_of(block_ids) -> np.ndarray:
    ids = np.asarray(block_ids)
    c, _ = np.nonzero(ids >= 0)
    out = np.empty(int((ids >= 0).sum()), np.int64)
    out[ids[ids >= 0]] = c
    return out


def _check_layout(data, n: int, metric: int = METRIC_L2) -> None:
    """Every id exactly once, no cluster over cap, pads -1 with +inf norms
    and zero rows; real slots hold their row in bf16 and its norm."""
    ids = data.block_ids.cpu().numpy()
    real = ids[ids >= 0]
    assert np.array_equal(np.sort(real), np.arange(n))
    assert ((ids >= 0).sum(axis=1) <= data.cap).all()
    sq = data.block_sq.cpu().numpy()
    assert np.isinf(sq[ids < 0]).all() and np.isfinite(sq[ids >= 0]).all()
    blk = data.blocks.float().cpu().numpy()
    assert (blk[ids < 0] == 0).all()
    rows = data.vectors[torch.from_numpy(real).long()].to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(blk[ids >= 0], rows)
    if metric == METRIC_IP:
        assert (sq[ids >= 0] == 0).all()


# --- one layout served by both ------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("probes", [2, 8, 32])
def test_search_matches_jax(jax_layouts, metric, probes):
    jidx, d = jax_layouts[metric]
    j_ids, j_d = jidx.search(d.queries, 10, probes=probes)
    t_ids, t_d = _carried(jidx, metric).search(d.queries, 10, probes=probes)
    _assert_close(j_ids, j_d, t_ids, t_d, _atol(d.base, d.queries))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_routed_search_matches_jax(jax_layouts, metric):
    jidx, d = jax_layouts[metric]
    q = d.queries[:NQ_ROUTED]
    mid = METRIC_L2 if metric == "l2" else METRIC_IP
    w = jivf.ivf_routed_search(jidx.data, jnp.asarray(q), k=10, metric=mid, **ROUTED)
    g = tivf.ivf_routed_search(_carried(jidx, metric).data, torch.from_numpy(q),
                               k=10, metric=mid, **ROUTED)
    _assert_close(w[0], w[1], g[0].numpy(), g[1].numpy(), _atol(d.base, q))
    assert float(g[2]) == float(w[2])
    np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))


@pytest.fixture(scope="module")
def int_case():
    """Small-integer rows and queries (exact in bf16, every product and sum
    exact in f32) in a JAX layout whose centroids are rounded to integers in
    both packages, so that stage 1 is exact too: many equal distances."""
    rng = np.random.default_rng(21)
    centers = rng.integers(-12, 13, size=(16, 16))
    base = (centers[rng.integers(0, 16, 3000)]
            + rng.integers(-2, 3, size=(3000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 128)]
         + rng.integers(-2, 3, size=(128, 16))).astype(np.float32)
    jidx = jivf.IVFIndex(base, num_clusters=24, seed=5)
    data = jidx.data._replace(centroids=jnp.round(jidx.data.centroids))
    return data, base, q


@pytest.mark.parametrize("route", ["search", "routed"])
def test_integer_rows_bit_for_bit(int_case, route):
    data, _, q = int_case
    port = ivf_from_jax(_arrays(data), metric="l2", device="cpu").data
    if route == "search":
        w = jivf.ivf_search(data, jnp.asarray(q), k=10, p=6, metric=METRIC_L2)
        g = tivf.ivf_search(port, torch.from_numpy(q), k=10, p=6, metric=METRIC_L2)
    else:
        kw = dict(k=10, p=6, shared=10, tile=32, metric=METRIC_L2)
        w = jivf.ivf_routed_search(data, jnp.asarray(q), **kw)
        g = tivf.ivf_routed_search(port, torch.from_numpy(q), **kw)
        assert float(g[2]) == float(w[2])
        np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
    np.testing.assert_array_equal(_bits(g[1].numpy()), _bits(w[1]))


def test_probe_products_keep_f32_results(int_case):
    """The probe scores are exact on integer rows whose products sum past
    256; a product with a bf16 result (torch's bf16 matmul) rounds them, so
    it would break the bit-for-bit case above."""
    data, _, q = int_case
    port = ivf_from_jax(_arrays(data), metric="l2", device="cpu").data
    qt = torch.from_numpy(q[:8])
    cols = torch.arange(4)[None].expand(8, 4)
    ids = port.block_ids[cols].reshape(8, -1)
    dots = torch.matmul(qt.to(torch.bfloat16).float()[:, None, None],
                        tivf._widened(port.blocks, cols).transpose(-1, -2)).reshape(8, -1)
    got = tivf._scores(dots, (qt * qt).sum(-1)[:, None],
                       port.block_sq[cols].reshape(8, -1), ids, METRIC_L2).numpy()
    rows = port.blocks[cols].double().reshape(8, -1, q.shape[1]).numpy()
    exact = ((q[:8, None, :].astype(np.float64) - rows) ** 2).sum(-1)
    valid = ids.numpy() >= 0
    np.testing.assert_array_equal(got[valid], exact[valid])
    bf16_dots = torch.matmul(qt.to(torch.bfloat16)[:, None],
                             port.blocks[cols].reshape(8, -1, q.shape[1]).transpose(1, 2))
    exact_dots = np.einsum("bd,bkd->bk", q[:8].astype(np.float64), rows)
    assert (bf16_dots[:, 0].double().numpy()[valid] != exact_dots[valid]).any()


# --- the builds ---------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_host_layout_bit_for_bit_with_centroids_given(metric, monkeypatch):
    """Integer rows, integer centroids given to both builds (their k-means
    and spatial order replaced): the choices, the capacity assignment (its
    overflow fallback included) and the fill are the same, bit for bit;
    ties between equal distances go the way numpy's selection sends them."""
    rng = np.random.default_rng(8)
    base = rng.integers(-3, 4, size=(2500, 12)).astype(np.float32)
    cents = rng.integers(-2, 3, size=(20, 12)).astype(np.float32)
    monkeypatch.setattr(jpl, "_lloyd", lambda pts, k, iters, seed: (jnp.asarray(cents), None))
    monkeypatch.setattr(jivf, "_spatial_order_centroids", lambda c, seed: np.arange(len(c)))
    monkeypatch.setattr(tpl, "_lloyd", lambda pts, k, iters, seed: (
        torch.from_numpy(cents).to(pts.device), None))
    monkeypatch.setattr(tivf, "_spatial_order_centroids", lambda c, seed: np.arange(len(c)))
    mid = METRIC_L2 if metric == "l2" else METRIC_IP
    w = jivf.build_ivf_layout(base, 20, metric=mid, seed=3, cap_slack=1.05)
    g = tivf.build_ivf_layout(base, 20, metric=mid, seed=3, cap_slack=1.05, device="cpu")
    for name in ("centroids", "block_sq", "block_ids", "vectors", "sqnorms"):
        np.testing.assert_array_equal(_bits(getattr(g, name).numpy()),
                                      _bits(getattr(w, name)), err_msg=name)
    np.testing.assert_array_equal(g.blocks.float().numpy(),
                                  np.asarray(w.blocks).astype(np.float32))
    _check_layout(g, len(base), mid)


def test_nearest_choices_are_numpys():
    """The R nearest of each row, ties and -0.0 included, as numpy's
    argpartition and stable argsort choose them."""
    rng = np.random.default_rng(4)
    d = rng.integers(0, 5, size=(300, 40)).astype(np.float32)
    d[::7, 3] = -0.0
    d[::5] = rng.random((60, 40)).astype(np.float32)  # rows with no tie
    got, got_d = tivf._nearest_choices(torch.from_numpy(d), 8)
    part = np.argpartition(d, 7, axis=1)[:, :8]
    pd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    np.testing.assert_array_equal(got, np.take_along_axis(part, order, axis=1))
    np.testing.assert_array_equal(_bits(got_d), _bits(np.take_along_axis(pd, order, axis=1)))


def _same_plan(g, w) -> None:
    """Each centroid within CENT_ATOL of one of the JAX package's, and >= 99%
    of the rows in the matching cluster (clusters matched by centroid: the
    spatial order may swap two near-tied neighbours, a relabelling)."""
    gc, wc = g.centroids.numpy(), np.asarray(w.centroids)
    d2 = ((gc[:, None].astype(np.float64) - wc[None]) ** 2).sum(-1)
    match = d2.argmin(axis=1)
    assert np.array_equal(np.sort(match), np.arange(len(wc)))
    np.testing.assert_allclose(gc, wc[match], atol=CENT_ATOL)
    same = match[_cluster_of(g.block_ids.numpy())] == _cluster_of(w.block_ids)
    assert same.mean() >= MIN_SAME_CLUSTER, same.mean()


def test_host_build_matches_jax_with_its_draw(ds, jax_layouts):
    """From scratch with the same seed: the farthest-point init's first
    centre is JAX's draw (the training sample is numpy's in both)."""
    for n in (64, len(ds.base)):
        assert tpl._draw_first(n, 7) == _jax_first(n, 7)
    g = IVFIndex(ds.base, num_clusters=64, seed=7, device="cpu")
    _same_plan(g.data, jax_layouts["l2"][0].data)
    _check_layout(g.data, len(ds.base))


def test_device_build_matches_jax_with_its_draws(ds):
    """The device build with the same seed: its training sample, initial
    centres and the spatial order's first centre are JAX's draws, bit for
    bit."""
    n = ts = len(ds.base)  # under 8192 rows the sample is every row, shuffled
    np.testing.assert_array_equal(tivf._draw_train_ids(n, ts, 7).numpy(),
                                  _jax_choice(n, ts, 7).numpy())
    np.testing.assert_array_equal(tivf._draw_init_ids(ts, 64, 7).numpy(),
                                  _jax_choice(ts, 64, 7).numpy())
    w = jivf.build_ivf_layout_device(jnp.asarray(ds.base), 64, seed=7)
    g = IVFIndex.from_device(torch.from_numpy(ds.base), num_clusters=64, seed=7,
                             device="cpu").data
    _same_plan(g, w)
    _check_layout(g, len(ds.base))
    np.testing.assert_allclose(g.sqnorms.numpy(), np.asarray(w.sqnorms), rtol=1e-6)


def test_device_build_refuses_a_small_sample(ds, capsys):
    with pytest.raises(ValueError, match="train_size"):
        tivf.build_ivf_layout_device(torch.from_numpy(ds.base), 64, train_size=32)
    tivf.build_ivf_layout_device(torch.from_numpy(ds.base[:1000]), 64, iters=1)
    assert "undertrained" in capsys.readouterr().err


def test_moderate_layout_served_by_both():
    """20,000 x 128 (auto C = 157, cap 160): one JAX layout, both searches."""
    d = synthetic_dataset(n=20_000, dim=128, num_queries=256, seed=17, compute_gt=False)
    jidx = jivf.IVFIndex(d.base, seed=3)
    assert jidx.data.num_clusters == 157
    j_ids, j_d = jidx.search(d.queries, 10, probes=16, batch_size=256)
    t_ids, t_d = _carried(jidx, "l2").search(d.queries, 10, probes=16, batch_size=256)
    _assert_close(j_ids, j_d, t_ids, t_d, _atol(d.base, d.queries))


# --- the port's own invariants ------------------------------------------------

def test_layout_partition(port_idx, ds):
    _check_layout(port_idx.data, len(ds.base))
    assert port_idx.data.cap == int(np.ceil(1.25 * len(ds.base) / 64))


def test_recall_rises_with_probes(port_idx, ds):
    r = [recall_at_k(port_idx.search(ds.queries, 10, probes=p)[0], ds.ground_truth, 10)
         for p in (2, 8, 32)]
    assert r[0] <= r[1] <= r[2] and r[1] > 0.9 and r[2] > 0.99, r


def test_probe_chunk_does_not_change_results(port_idx, ds):
    q = torch.from_numpy(ds.queries)
    a = tivf.ivf_search(port_idx.data, q, k=10, p=8, metric=METRIC_L2)
    for pc in (2, 3):  # 3 -> 2, a divisor of p
        b = tivf.ivf_search(port_idx.data, q, k=10, p=8, metric=METRIC_L2, probe_chunk=pc)
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(_bits(a[1].numpy()), _bits(b[1].numpy()))


def test_routed_streamed_groups_match_one_step(port_idx, ds):
    q = torch.from_numpy(ds.queries[:NQ_ROUTED])
    a = tivf.ivf_routed_search(port_idx.data, q, k=10, metric=METRIC_L2, **ROUTED)
    b = tivf.ivf_routed_search(port_idx.data, q, k=10, metric=METRIC_L2,
                               step_budget=1, **ROUTED)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y.numpy()))


def test_routed_recall_and_order_restored(port_idx, ds):
    ids, dists, st = port_idx.search_routed(ds.queries, 10, probes=8, shared=48,
                                            tile=32, with_stats=True)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.9
    assert st["probe_coverage"] > 0.85 and st["tiles"] == 7 and st["shared"] == 48
    assert np.all(np.diff(dists, axis=1) >= 0)
    perm = np.random.default_rng(3).permutation(len(ds.queries))
    i2, _ = port_idx.search_routed(ds.queries[perm], 10, probes=8, shared=48, tile=32)
    r1 = recall_at_k(ids[perm], ds.ground_truth[perm], 10)
    assert abs(r1 - recall_at_k(i2, ds.ground_truth[perm], 10)) < 0.05


def test_fallback_above_one_is_the_per_query_search(port_idx, ds):
    ri, rd, st = port_idx.search_routed(ds.queries, 10, probes=8, shared=16, tile=64,
                                        fallback=1.1, with_stats=True)
    assert st["fallback_queries"] == len(ds.queries)
    pi, pd = port_idx.search(ds.queries, 10, probes=8)
    np.testing.assert_array_equal(ri, pi)
    np.testing.assert_array_equal(_bits(rd), _bits(pd))


def test_default_fallback_floor(port_idx, ds):
    ids, _, st = port_idx.search_routed(ds.queries, 10, probes=8, shared=4, tile=64,
                                        with_stats=True)
    assert st["fallback_queries"] > 0
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.85


def test_preloaded_queries_are_repadded(port_idx, ds):
    a = port_idx.search_routed(ds.queries, 10, probes=8, shared=48, tile=32)
    pre = port_idx.preload(ds.queries, batch_size=48)  # 240 rows; the call's batch 224
    b = port_idx.search_routed(ds.queries, 10, probes=8, shared=48, tile=32,
                               preloaded=pre)
    np.testing.assert_array_equal(a[0], b[0])


def test_routed_layout(ds):
    idx = IVFIndex(ds.base, seed=7, layout="routed", train_size=6000, device="cpu")
    assert idx.data.num_clusters == tivf._auto_clusters(6000, 128, "routed") <= 2048
    ids, _ = idx.search_routed(ds.queries, 10, probes=8, shared=32, tile=32)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.9
    with pytest.raises(ValueError, match="layout"):
        tivf._auto_clusters(10, 128, "coarse")


@pytest.fixture(scope="module")
def large_c():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(4608, 8)).astype(np.float32)
    q = rng.normal(size=(32, 8)).astype(np.float32)
    idx = IVFIndex(base, num_clusters=4096, seed=7, train_size=4608, device="cpu")
    return idx, base, q


def test_full_probes_exact_at_large_c(large_c):
    idx, base, q = large_c
    gt, _ = brute_force_knn(base, q, 10)
    ids, _ = idx.search(q, 10, probes=4096, rerank=8)
    assert recall_at_k(ids, gt, 10) == pytest.approx(1.0)


def test_jax_approx_probes_exact_on_the_cpu(large_c):
    """The JAX package's approx_probes (approx_max_k from 4096 clusters) is
    exact off a TPU: the same results as exact probes, and as the port's."""
    idx, base, q = large_c
    data = _jax_data(idx.data)
    a = jivf.ivf_search(data, jnp.asarray(q), k=10, p=64, metric=METRIC_L2,
                        approx_probes=True)
    b = jivf.ivf_search(data, jnp.asarray(q), k=10, p=64, metric=METRIC_L2)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    g = tivf.ivf_search(idx.data, torch.from_numpy(q), k=10, p=64, metric=METRIC_L2,
                        approx_probes=True)
    _assert_close(b[0], b[1], g[0].numpy(), g[1].numpy(), _atol(base, q))


def test_cost_counters_match_jax(jax_layouts):
    jidx, _ = jax_layouts["l2"]
    port = _carried(jidx, "l2")
    assert port.cost_counters(1000, 10, probes=8, batch_size=256) == \
        jidx.cost_counters(1000, 10, probes=8, batch_size=256)
    assert port.routed_cost_counters(1000, 10, probes=8, shared=48, tile=32) == \
        jidx.routed_cost_counters(1000, 10, probes=8, shared=48, tile=32)


def test_entry_points_need_a_card_unless_asked(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        IVFIndex(ds.base[:512], num_clusters=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        IVFIndex.from_device(torch.from_numpy(ds.base[:512]), num_clusters=8)
