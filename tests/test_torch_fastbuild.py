"""The scan-speed graph build of the port (shine_tpu_torch.models.fastbuild,
models/build.py and the native reverse merge) against the JAX package's
``shine_tpu.models.fastbuild`` and ``shine_tpu.models.build``: the integer
and ordering stages bit for bit, and the whole build bit for bit on
integer-valued rows (the port's block-max route against the JAX interpret
route, whose every score and distance is exact), by overlap and recall on
Gaussian rows. Torch runs on one thread, as the JAX package's CPU tests
effectively do."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams as JHNSWParams
from shine_tpu.models import build as jbuild
from shine_tpu.models import fastbuild as jfb
from shine_tpu_torch import HNSWIndex, native
from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.graph.soa import GraphSoA
from shine_tpu_torch.io import recall_at_k, synthetic_dataset
from shine_tpu_torch.models import build as tbuild
from shine_tpu_torch.models import fastbuild as tfb

N, D, M = 8192, 16, 8
FIELDS = ("levels", "neighbors0", "upper_row", "upper_neighbors")
# Gaussian rows: the two builds' f32 sums differ by ulps, which reorders a
# few near-tied candidates; measured overlap ~0.99 of the layer-0 lists
MIN_OVERLAP = 0.95
RECALL_GAP = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_draw_levels_bit_for_bit():
    for seed, m in ((42, 8), (7, 16), (3, 32)):
        want = jbuild.draw_levels(50_000, JHNSWParams(M=m, seed=seed))
        got = tbuild.draw_levels(50_000, HNSWParams(M=m, seed=seed))
        np.testing.assert_array_equal(got, want)


def _select_case(rng, B=64, C=24, d=8, n=300):
    v = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    ids = np.stack([rng.choice(n, C, replace=False) for _ in range(B)]).astype(np.int32)
    dist = ((v[ids] - q[:, None, :]) ** 2).sum(-1).astype(np.float32)
    order = np.lexsort((ids, dist), axis=1)
    ids, dist = np.take_along_axis(ids, order, 1), np.take_along_axis(dist, order, 1)
    ids[:, -3:] = -1  # pads
    dist[:, -3:] = np.inf
    vecs = v[np.maximum(ids, 0)]
    sq = (vecs * vecs).sum(-1).astype(np.float32)
    return ids, dist, vecs, sq


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("with_dists", [False, True])
@pytest.mark.parametrize("metric", [0, 1])
def test_select_heuristic_bit_for_bit(fill, with_dists, metric):
    rng = np.random.default_rng(5 + metric)
    args = _select_case(rng)
    want = jbuild.select_heuristic(*(jnp.asarray(a) for a in args), 6, metric,
                                   fill=fill, with_dists=with_dists)
    got = tbuild.select_heuristic(*(torch.from_numpy(a) for a in args), 6, metric,
                                  fill=fill, with_dists=with_dists)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drop_self_bit_for_bit():
    rng = np.random.default_rng(3)
    n, w, k = 257, 9, 8
    dd = np.sort(rng.random((n, w)).astype(np.float32), axis=1)
    ii = (n + rng.integers(0, n, (n, w))).astype(np.int32)
    rows = rng.choice(n, n // 2, replace=False)
    ii[rows, rng.integers(0, w, n // 2)] = rows  # one self hit in half the rows
    ii[rows[:20], -1] = -1
    dd[rows[:20], -1] = np.inf
    want = jfb._drop_self_sorted(ii, dd, k)
    got = tfb._drop_self_sorted(ii, dd, k)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g, wt)
    lo = 100  # a sweep batch of rows lo .. lo + 64
    sub_i = ii[lo:lo + 64].copy()
    want = jfb._drop_self_dev(jnp.asarray(sub_i), jnp.asarray(dd[lo:lo + 64]),
                              jnp.int32(lo), k=k)
    got = tfb._drop_self_dev(torch.from_numpy(sub_i), torch.from_numpy(dd[lo:lo + 64]),
                             lo, k=k)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))


def _merge_case(rng, n, M, idspace):
    """Forward lists with heavy distance ties, mutual edges, non-contiguous
    ids and -1 pads (the JAX package's adversarial case)."""
    ids = np.sort(rng.choice(idspace, size=n, replace=False)).astype(np.int32)
    fwd_sel = np.empty((n, M), np.int32)
    fwd_d = np.empty((n, M), np.float32)
    for i in range(n):
        nb = rng.choice(n, size=M, replace=False)
        nb = nb[nb != i]
        d = np.round(rng.random(len(nb)) * 8) / 4
        order = np.lexsort((ids[nb], d))
        k = len(nb) - int(rng.integers(0, 3))
        fwd_sel[i, :k] = ids[nb[order]][:k]
        fwd_d[i, :k] = d[order][:k]
        fwd_sel[i, k:] = -1
        fwd_d[i, k:] = np.inf
    return fwd_sel, fwd_d, ids


@pytest.mark.parametrize("n,M,cap_c,idspace", [(500, 8, 12, 1000), (2000, 6, 7, 2000)])
def test_reverse_merge_native_and_numpy_bit_for_bit(n, M, cap_c, idspace):
    rng = np.random.default_rng(7 + n)
    fwd_sel, fwd_d, ids = _merge_case(rng, n, M, idspace)
    want = jfb._reverse_merge_np(fwd_sel, fwd_d, ids, cap_c)
    twin = tfb._reverse_merge_np(fwd_sel, fwd_d, ids, cap_c)
    for threads in (0, 1, 3):
        got = native.reverse_merge(fwd_sel, fwd_d, ids, cap_c, threads=threads)
        for g, t, w in zip(got, twin, want):
            np.testing.assert_array_equal(t, w)
            np.testing.assert_array_equal(g, w)
    got = tfb._reverse_merge(fwd_sel, fwd_d, ids, cap_c, native_merge=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,d,k,kb,batch,layout,keep2,fused", [
    (1_000_000, 128, 32, 49, 4096, "ext", True, True),
    (1_000_000, 128, 200, 217, 4096, "ext", True, False),
    (16_777_216, 128, 64, 128, 2048, "int8", True, True),
    (10_485_760, 96, 500, 564, 1024, "bf16", False, True),
])
def test_sweep_plan_arithmetic_matches_jax(n, d, k, kb, batch, layout, keep2, fused):
    want = jfb._sweep_plan(n, d, k, kb, batch, 1024, layout, keep2, fused=fused)
    got = tfb._sweep_plan(n, d, k, kb, batch, 1024, layout, keep2, fused=fused)
    assert got == want
    blk = tfb._sweep_plan(n, d, k, kb, batch, 1024, layout, keep2, fused=fused,
                          blockmax=True)
    # the block-max route: K5's four (batch, n/128) planes and the select's
    # int64 keys in place of the class-max outputs
    assert blk["scan_blocks"] == batch * (n // 128) * 24
    assert blk["scan_classtable"] == 0


def test_sweep_index_refuses_a_plan_over_budget():
    base = torch.zeros((8192, 16))
    with pytest.raises(RuntimeError, match="exceeds the budget"):
        tfb._sweep_index(base, 16, 0, hbm_bytes=1e6)
    with pytest.raises(RuntimeError, match="block-max"):
        tfb._sweep_index(base, 16, 0, blockmax=True, hbm_bytes=1e6)
    _, _, plan = tfb._sweep_index(base, 16, 0, layout="int8")
    assert plan["layout"] == "int8" and plan["kb"] == 96
    with pytest.raises(ValueError):
        tfb._sweep_index(base, 16, 0, layout="f32")


@pytest.fixture(scope="module")
def int_rows():
    rng = np.random.default_rng(0)
    return rng.integers(-8, 9, size=(N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def gauss():
    return synthetic_dataset(n=N, dim=D, num_queries=200, seed=21)


@pytest.mark.parametrize("route", ["device", "host", "pool"])
def test_build_bit_for_bit_on_integer_rows(int_rows, route):
    """The port's block-max build equals the JAX interpret build field for
    field: the device sweep (base_dev), the host path, and a wide pool."""
    kw = {"pool": 24} if route == "pool" else {}
    jkw = dict(kw, interpret=True)
    tkw = dict(kw, blockmax=True)
    if route != "host":
        jkw["base_dev"] = jnp.asarray(int_rows)
        tkw["base_dev"] = torch.from_numpy(int_rows)
    else:
        tkw["device"] = "cpu"
    want = jfb.fast_build_graph(int_rows, JHNSWParams(M=M, ef_construction=50), **jkw)
    timings = {}
    got = tfb.fast_build_graph(int_rows, HNSWParams(M=M, ef_construction=50),
                               timings=timings, **tkw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.entry_point, got.top_level) == (want.entry_point, want.top_level)
    assert ("knn_select" in timings["levels"][0]) == (route != "host")


def _overlap(a, b):
    """Mean share of each vertex's layer-0 list (ids >= 0) found in the
    other build's list."""
    hits = [(np.intersect1d(x[x >= 0], y[y >= 0]).size, (x >= 0).sum())
            for x, y in zip(a, b)]
    return sum(h for h, _ in hits) / max(sum(t for _, t in hits), 1)


def _recall(graph, ds):
    idx = HNSWIndex(graph, device="cpu")
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=200)
    return recall_at_k(ids, ds.ground_truth, 10)


@pytest.mark.parametrize("route", ["device", "host"])
def test_build_gaussian_matches_jax(gauss, route):
    p = dict(M=M, ef_construction=50)
    jkw, tkw = {"interpret": True}, {"blockmax": True}
    if route == "device":
        jkw["base_dev"] = jnp.asarray(gauss.base)
        tkw["base_dev"] = torch.from_numpy(gauss.base)
    else:
        tkw["device"] = "cpu"
    want = jfb.fast_build_graph(gauss.base, JHNSWParams(**p), **jkw)
    got = tfb.fast_build_graph(gauss.base, HNSWParams(**p), **tkw)
    np.testing.assert_array_equal(got.levels, np.asarray(want.levels))
    assert got.entry_point == want.entry_point
    assert _overlap(got.neighbors0, np.asarray(want.neighbors0)) >= MIN_OVERLAP
    r_got, r_want = _recall(got, gauss), _recall(GraphSoA.from_fields(want), gauss)
    assert abs(r_got - r_want) <= RECALL_GAP and r_got > 0.9


def test_class_max_sweep_on_the_cpu(gauss):
    """The card's default route (class-max sweep, fused select) run on CPU
    tensors: the same levels, and the recall of the block-max build."""
    timings = {}
    got = tfb.fast_build_graph(gauss.base, HNSWParams(M=M, ef_construction=50),
                               base_dev=torch.from_numpy(gauss.base), timings=timings)
    plan = timings["plan"]
    assert (plan["layout"], plan["batch"], plan["keep2"]) == ("ext", 4096, True)
    assert _recall(got, gauss) > 0.9
    host = tfb.fast_build_graph(gauss.base, HNSWParams(M=M, ef_construction=50),
                                base_dev=torch.from_numpy(gauss.base),
                                host_select=True)
    for f in FIELDS:  # the fused sweep and select == the host-table route
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f))


def test_stage_files_load_in_both_packages(int_rows, tmp_path):
    p_t, p_j = HNSWParams(M=M, ef_construction=50), JHNSWParams(M=M, ef_construction=50)
    t_stage, j_stage = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_base, j_base = torch.from_numpy(int_rows), jnp.asarray(int_rows)
    tfb.fast_build_graph(int_rows, p_t, blockmax=True, base_dev=t_base,
                         stage_path=t_stage)
    jfb.fast_build_graph(int_rows, p_j, interpret=True, base_dev=j_base,
                         stage_path=j_stage)
    for stage in (t_stage, j_stage):
        assert os.path.exists(stage)
        timings = {}
        a = tfb.fast_build_graph(int_rows, p_t, blockmax=True, base_dev=t_base,
                                 stage_path=stage, timings=timings)
        assert timings["levels"][0]["n"] < N  # layer 0 came from the file
        b = jfb.fast_build_graph(int_rows, p_j, interpret=True, base_dev=j_base,
                                 stage_path=stage)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))
    # another M: the file is ignored, the whole build runs
    timings = {}
    g = tfb.fast_build_graph(int_rows, HNSWParams(M=6), blockmax=True,
                             base_dev=t_base, stage_path=t_stage, timings=timings)
    assert g.neighbors0.shape[1] == 12 and timings["levels"][0]["n"] == N


def test_build_defaults_to_the_card_and_refuses_a_mesh(int_rows):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tfb.fast_build_graph(int_rows, HNSWParams(M=M))
    with pytest.raises(NotImplementedError, match="A8c"):
        tfb.fast_build_graph(int_rows, HNSWParams(M=M), device="cpu", mesh=object())
    with pytest.raises(ValueError):
        tfb.fast_build_graph(int_rows, HNSWParams(M=M), device="cuda",
                             base_dev=torch.from_numpy(int_rows))


def test_device_sweep_takes_a_ragged_last_batch():
    """n = 6000 rows, not a multiple of the sweep's batch (the JAX package
    asks for one; the 1M set's sweep ends on a batch of 576 rows): the fused
    sweep and select equals the host-table route, every row has its own
    lists, and the graph serves."""
    ds = synthetic_dataset(n=6000, dim=D, num_queries=100, seed=23)
    p = HNSWParams(M=M, ef_construction=50)
    base = torch.from_numpy(ds.base)
    timings = {}
    fused = tfb.fast_build_graph(ds.base, p, base_dev=base, timings=timings)
    assert timings["plan"]["batch"] == 4096
    host = tfb.fast_build_graph(ds.base, p, base_dev=base, host_select=True)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(fused, f), getattr(host, f))
    assert (fused.neighbors0[:, 0] >= 0).all()
    assert not (fused.neighbors0 == np.arange(6000)[:, None]).any()  # no self edges
    assert _recall(fused, ds) > 0.9
