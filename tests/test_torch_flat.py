"""The port's brute-force indexes (shine_tpu_torch.models.flat) and their
re-rank helpers (shine_tpu_torch.ops.distance) against shine_tpu.models.flat
and shine_tpu.ops.distance. FastFlatIndex's class-max routes are held
against the JAX route of ``fast_flat_search`` (the keep1/keep2,
fused/unfused scan branches) built by hand from the interpret-mode Pallas
kernels, ``lax.top_k`` and ``rerank_topk``, because the JAX FastFlatIndex
itself takes the block-max kernel (K5) when it interprets on the CPU. The
port's own block-max route (``blockmax=True``) is held against that JAX
index directly in tests/test_torch_blockmax.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.io import brute_force_knn as j_brute_force_knn
from shine_tpu.models import flat as jf
from shine_tpu.ops import distance as jd
from shine_tpu.ops import pallas_scan3 as j3
from shine_tpu.ops.pallas_scan import pack_ext_query as j_pack_ext_query
from shine_tpu_torch import FastFlatIndex, FlatIndex, fastflat_from_jax
from shine_tpu_torch.io import recall_at_k, synthetic_dataset
from shine_tpu_torch.models import flat as tf
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops import distance as td

# distances of O(1e2) summed in other orders by the two frameworks
RTOL, ATOL = 1e-5, 1e-3


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _cands(rng, B, K, n):
    ids = rng.integers(0, n, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.15] = -1
    ids[:, 1] = ids[:, 0]  # duplicates
    return ids


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("integer", [True, False])
def test_rerank_topk_matches_jax(metric, integer):
    rng = np.random.default_rng(metric + 2 * integer)
    n, d, B, K, k = 300, 16, 12, 40, 10
    v = _ints(rng, (n, d)) if integer else rng.normal(size=(n, d)).astype(np.float32)
    q = _ints(rng, (B, d)) if integer else rng.normal(size=(B, d)).astype(np.float32)
    sq = (v * v).sum(-1)
    ids = _cands(rng, B, K, n)
    wd, wi = jd.rerank_topk(jnp.asarray(v), jnp.asarray(sq), jnp.asarray(q),
                            jnp.asarray(ids), k, metric)
    gd, gi = td.rerank_topk(torch.from_numpy(v), torch.from_numpy(sq),
                            torch.from_numpy(q), torch.from_numpy(ids), k, metric)
    if integer:  # exact sums: bit for bit, ties and all
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    else:
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [0, 1])
def test_rerank_topk_ext_and_prerank_trim_match_jax(metric):
    from shine_tpu.ops.pallas_scan import pack_ext_table as j_pack
    from shine_tpu_torch.ops.scan import pack_ext_query, pack_ext_table

    rng = np.random.default_rng(7 + metric)
    n, d, B, K, k = 500, 16, 10, 48, 10
    v, q = _ints(rng, (n, d)), _ints(rng, (B, d))
    ids = _cands(rng, B, K, n)
    j_ext = jnp.asarray(j_pack(v, metric, 4096), jnp.bfloat16)
    t_ext = pack_ext_table(v, metric, 4096)
    wd, wi = jd.rerank_topk_ext(j_ext, jnp.asarray(q), jnp.asarray(ids), k, metric)
    gd, gi = td.rerank_topk_ext(t_ext, torch.from_numpy(q), torch.from_numpy(ids),
                                k, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for pre in (5, 20):
        j_qe = j_pack_ext_query(jnp.asarray(q), j_ext.shape[1]).astype(jnp.bfloat16)
        t_qe = pack_ext_query(torch.from_numpy(q), t_ext.shape[1])
        want = jd.prerank_trim_ext(j_ext, j_qe, jnp.asarray(ids), pre)
        got = td.prerank_trim_ext(t_ext, t_qe, torch.from_numpy(ids), pre)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pre", [1, 6, 30])
def test_score_trim_matches_jax(pre):
    rng = np.random.default_rng(pre)
    vals = _ints(rng, (9, 32), -3, 3)
    ids = _cands(rng, 9, 32, 100)
    want = jd.score_trim(jnp.asarray(vals), jnp.asarray(ids), pre)
    got = td.score_trim(torch.from_numpy(vals), torch.from_numpy(ids), pre)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_route(jidx, queries, *, k, kb, cls, keep2, fused, prerank=0):
    """The JAX package's fast_flat_search scan branches (flat.py:1099-1168)
    with its interpret-mode kernels, in the caller's id space."""
    q = jnp.asarray(queries, jnp.float32)
    q_ext = j_pack_ext_query(q, jidx.ext.shape[1]).astype(jnp.bfloat16)
    kw = dict(tq=q.shape[0], tn=max(2048, cls), cls=cls, interpret=True)
    if keep2:
        if fused:
            v1, cand1, v2, c2 = j3.classmax2_topk_scan(jidx.ext, q_ext, kb=kb, **kw)
        else:
            m1, a1, m2, a2 = j3.classmax2_scan(jidx.ext, q_ext, **kw)
            v1, sel = jax.lax.top_k(m1, kb)
            cand1 = jnp.take_along_axis(a1, sel, axis=1)
            c2 = jnp.take_along_axis(a2, sel, axis=1)
            v2 = jnp.take_along_axis(m2, sel, axis=1)
        cand = jnp.concatenate([cand1, jnp.where(v2 > -3e38, c2, -1)], axis=1)
        vals = jnp.concatenate([v1, v2], axis=1)
    elif fused:
        vals, cand = j3.classmax_topk_scan(jidx.ext, q_ext, kb=kb, **kw)
    else:
        m1, a1 = j3.classmax_scan(jidx.ext, q_ext, **kw)
        vals, sel = jax.lax.top_k(m1, kb)
        cand = jnp.take_along_axis(a1, sel, axis=1)
    cand = jnp.where(cand < jidx.n, cand, -1)
    if prerank and max(prerank, k) < cand.shape[-1]:
        cand = jd.score_trim(vals, cand, max(prerank, k))
    dists, ids = jd.rerank_topk(jidx.vectors, jidx.sqnorms, q, cand, k, jidx.metric)
    ids = np.asarray(ids)
    return np.where(ids >= 0, jidx.perm[np.maximum(ids, 0)], -1), np.asarray(dists)


@pytest.fixture(scope="module")
def int_case():
    """Integer rows and queries: every scan score and distance is exact in
    both packages, so their routes must return the same ids."""
    rng = np.random.default_rng(21)
    base = _ints(rng, (7000, 16))
    queries = base[rng.integers(0, 7000, 48)] + _ints(rng, (48, 16), -1, 2)
    return base, queries, jf.FastFlatIndex(base, interpret=True)


@pytest.mark.parametrize("keep2,fused,prerank", [
    (False, False, 0), (False, True, 0), (True, False, 0), (True, True, 0),
    (False, False, 12), (True, True, 12),
])
def test_fastflat_routes_match_jax(int_case, keep2, fused, prerank):
    base, queries, jidx = int_case
    kb, cls, k = 8, 256, 10
    want_i, want_d = _jax_route(jidx, queries, k=k, kb=kb, cls=cls,
                                keep2=keep2, fused=fused, prerank=prerank)
    idx = FastFlatIndex(base, device="cpu")
    np.testing.assert_array_equal(idx.perm, jidx.perm)
    got_i, got_d = idx.search(queries, k, kb=kb, cls=cls, keep2=keep2,
                              fused_sel=fused, prerank=prerank, batch_size=32)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_fastflat_from_jax_serves_the_jax_state(int_case):
    base, queries, jidx = int_case
    arrays = {"ext": np.asarray(jidx.ext), "vectors": np.asarray(jidx.vectors),
              "sqnorms": np.asarray(jidx.sqnorms), "perm": jidx.perm}
    conv = fastflat_from_jax(arrays, n=jidx.n, dim=jidx.dim, metric="l2",
                             device="cpu")
    own = FastFlatIndex(base, device="cpu")
    assert torch.equal(conv.ext.view(torch.int16), own.ext.view(torch.int16))
    kw = dict(kb=8, cls=256, keep2=True, fused_sel=True)
    want_i, _ = _jax_route(jidx, queries, k=10, kb=8, cls=256, keep2=True,
                           fused=True)
    got_i, _ = conv.search(queries, 10, **kw)
    np.testing.assert_array_equal(got_i, want_i)
    table_only = fastflat_from_jax({"ext": arrays["ext"], "perm": jidx.perm},
                                   n=jidx.n, dim=jidx.dim, metric="l2",
                                   device="cpu")
    assert table_only.vectors is None
    ids, _ = table_only.search(queries, 10, **kw)
    assert recall_at_k(ids, got_i, 10) > 0.9


def test_fastflat_from_jax_rejects_a_narrow_table():
    with pytest.raises(ValueError):
        fastflat_from_jax({"ext": np.zeros((4096, 16), np.float32)}, n=10,
                          dim=16, metric="l2", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fastflat_recall_against_brute_force(metric):
    ds = synthetic_dataset(n=8192, dim=32, num_queries=64, seed=5, metric=metric)
    idx = FastFlatIndex(ds.base, metric=metric, device="cpu")
    kb, cls, keep2, fused = idx._resolve_knobs(0, 0, None, None, False)
    assert (kb, cls, keep2, fused) == (32, 2048, False, False)
    ids, dists = idx.search(ds.queries, 10)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.97
    assert np.all(np.diff(dists, axis=1) >= 0)
    # the JAX package's oracle agrees with the port's
    want, _ = j_brute_force_knn(ds.base, ds.queries, 10, metric=metric)
    np.testing.assert_array_equal(want, ds.ground_truth[:, :10])


def test_fastflat_search_device_megabatch_and_dists_off():
    ds = synthetic_dataset(n=4096, dim=16, num_queries=70, seed=2, compute_gt=False)
    idx = FastFlatIndex(ds.base, device="cpu")
    a_i, a_d = idx.search(ds.queries, 5, kb=16, batch_size=32, tq=32)
    b_i, b_d = idx.search(ds.queries, 5, kb=16, batch_size=32, tq=32,
                          megabatch=True)
    np.testing.assert_array_equal(a_i, b_i)
    np.testing.assert_array_equal(a_d, b_d)
    pre = idx.preload(ds.queries, batch_size=32)
    c_i, c_d = idx.search_device(pre, 5, kb=16, batch_size=32, tq=32)
    np.testing.assert_array_equal(c_i.numpy(), a_i)
    _, z = idx.search(ds.queries, 5, kb=16, batch_size=32, tq=32,
                      with_dists=False)
    assert not z.any()


@pytest.mark.parametrize("side", ["under", "over"])
def test_fastflat_from_device_shuffle_rule_matches_jax(monkeypatch, side):
    """``shuffle=None`` shuffles while the transient f32 copy, n * d * 4
    bytes, fits ``SHUFFLE_MAX_BYTES`` (both packages' module constants,
    patched to sit just at or just under this set's size), and keeps the
    rows in their order above it. Integer rows, so that the port's
    block-max route and the JAX index's interpret route agree bit for
    bit: the same permutation, the same table and the same ids."""
    rng = np.random.default_rng(22)
    n, d = 8192, 16
    v = _ints(rng, (n, d))
    q = v[rng.integers(0, n, 64)] + _ints(rng, (64, d), -1, 2)
    limit = n * d * 4 - (side == "over")
    monkeypatch.setattr(tf, "SHUFFLE_MAX_BYTES", limit)
    monkeypatch.setattr(jf, "SHUFFLE_MAX_BYTES", limit)
    got = FastFlatIndex.from_device(torch.from_numpy(v), seed=5, blockmax=True)
    want = jf.FastFlatIndex.from_device(jnp.asarray(v), seed=5)
    if side == "over":
        assert got.perm is None and want.perm is None
    else:
        np.testing.assert_array_equal(got.perm, want.perm)
    w = d + 2  # the packed columns; the rest of each table is zero
    g_ext = got.ext.to(torch.float32).numpy()
    w_ext = np.asarray(want.ext.astype(jnp.float32))
    np.testing.assert_array_equal(g_ext[:, :w], w_ext[:, :w])
    assert not g_ext[:, w:].any() and not w_ext[:, w:].any()
    kw = dict(kb=8, batch_size=64)
    np.testing.assert_array_equal(got.search(q, 10, **kw)[0], want.search(q, 10, **kw)[0])


def test_fastflat_from_device_and_from_ext():
    ds = synthetic_dataset(n=8192, dim=16, num_queries=32, seed=3)
    dev_idx = FastFlatIndex.from_device(torch.from_numpy(ds.base), seed=1)
    # the shuffle is the JAX package's from the same seed, bit for bit
    jax_idx = jf.FastFlatIndex.from_device(jnp.asarray(ds.base), seed=1)
    np.testing.assert_array_equal(dev_idx.perm, jax_idx.perm)
    ids, _ = dev_idx.search(ds.queries, 10)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.97
    ext_idx = FastFlatIndex.from_ext(dev_idx.ext, 8192, dim=16)
    e_ids, _ = ext_idx.search(ds.queries, 10)
    # no permutation on a table-only index: map its rows back by hand
    e_ids = dev_idx.perm[e_ids]
    assert recall_at_k(e_ids, ds.ground_truth, 10) > 0.9
    # a row-keyed table with its row source re-ranks exactly from rows
    # regenerated by id: its distances are those of the exact rows
    from shine_tpu_torch.io.device_synth import device_rowkeyed_ext_dataset
    from shine_tpu_torch.ops.regen import regen_rows

    rk = device_rowkeyed_ext_dataset(n=8192, dim=16, num_queries=32, seed=3,
                                     num_clusters=8, device="cpu")
    rs_idx = FastFlatIndex.from_ext(rk.ext_dev, rk.n, dim=16, row_source=rk.row_source)
    r_ids, r_d = rs_idx.search(rk.queries, 10, kb=32)
    assert recall_at_k(r_ids, rk.ground_truth, 10) > 0.97
    rows = regen_rows(*rk.row_source, torch.from_numpy(r_ids[:, 0].astype(np.int64)))
    want = ((rows.numpy() - rk.queries) ** 2).sum(1)
    np.testing.assert_allclose(r_d[:, 0], want, rtol=1e-5, atol=1e-3)


def test_cost_counters_match_jax_shapes():
    ds = synthetic_dataset(n=5000, dim=16, num_queries=8, seed=1, compute_gt=False)
    idx = FastFlatIndex(ds.base, device="cpu")
    c = idx.cost_counters(10_000)
    assert c["scanned_rows"] == 10_000 * 8192
    assert c["hbm_gather_bytes"] == 3 * 8192 * 32 * 2 + 10_000 * 32 * 16 * 4


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("use_bf16", [True, False])
def test_flat_index_matches_jax(metric, use_bf16):
    rng = np.random.default_rng(3)
    base, queries = _ints(rng, (3000, 16)), _ints(rng, (40, 16))
    want_i, want_d = jf.FlatIndex(base, metric=metric).search(
        queries, 10, batch_size=16, chunk=1024, use_bf16=use_bf16)
    got_i, got_d = FlatIndex(base, metric=metric, device="cpu").search(
        queries, 10, batch_size=16, chunk=1024, use_bf16=use_bf16)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_flat_index_gaussian():
    ds = synthetic_dataset(n=3000, dim=24, num_queries=32, seed=8)
    want_i, want_d = jf.FlatIndex(ds.base).search(ds.queries, 10, chunk=1024)
    got_i, got_d = FlatIndex(ds.base, device="cpu").search(ds.queries, 10,
                                                           chunk=1024)
    assert recall_at_k(got_i, want_i, 10) >= 0.99
    assert recall_at_k(got_i, ds.ground_truth, 10) >= 0.99
    same = got_i == want_i
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=RTOL, atol=ATOL)
    e_i, _ = FlatIndex(ds.base, device="cpu").search(ds.queries, 10, chunk=1024,
                                                     use_bf16=False)
    np.testing.assert_array_equal(e_i, ds.ground_truth[:, :10])


def test_kb_and_keep2_auto_match_jax():
    for n, d in ((8192, 16), (1_003_520, 128), (200_704, 960), (999_424, 64)):
        assert tf.kb_auto(n, d) == jf.kb_auto(n, d)
        for cls in (1024, 2048):
            assert tf.keep2_auto(n, cls) == jf.keep2_auto(n, cls)


def test_cpu_search_launches_no_kernel():
    ds = synthetic_dataset(n=4096, dim=16, num_queries=8, seed=4, compute_gt=False)
    before = [f.launches for f in (cm.classmax_scan, cm.classmax2_scan,
                                   cm.classmax_topk_scan, cm.classmax2_topk_scan)]
    FastFlatIndex(ds.base, device="cpu").search(ds.queries, 5)
    after = [f.launches for f in (cm.classmax_scan, cm.classmax2_scan,
                                  cm.classmax_topk_scan, cm.classmax2_topk_scan)]
    assert before == after
