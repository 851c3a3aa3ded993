"""The split-layout slice of the port (K3 and SplitFlatIndex) against the JAX
package: ``shine_tpu_torch.ops.scan_split`` against
``shine_tpu.ops.pallas_scan_split``'s packing, the K3 twins of
``shine_tpu_torch.ops.classmax`` against its Pallas kernels run in interpret
mode (as tests/test_split.py runs them), the split re-ranks against
``shine_tpu.ops.distance`` and ``SplitFlatIndex`` against the JAX
``SplitFlatIndex``. On the CPU the port's wrappers run their plain twins;
the CUDA kernel is held against the twins in tests/test_torch_kernel.py, on
a card."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.models import flat as jf
from shine_tpu.ops import distance as jd
from shine_tpu.ops import pallas_scan_split as js
from shine_tpu_torch import SplitFlatIndex, splitflat_from_jax
from shine_tpu_torch.io import recall_at_k, synthetic_dataset
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops import distance as td
from shine_tpu_torch.ops import scan_split as ts

B = 64
# Gaussian split scores (|score| up to ~1e2) sum <= 48 bf16 products, each
# exact in f32, in another order, then scale and shift: a few f32 ulps
GAUSS_ATOL = 1e-4
# distances of O(1e2) summed in other orders by the two frameworks
RTOL, ATOL = 1e-5, 1e-3
_DT = {"bf16": np.float16, "int8": np.int8}  # the JAX packer's sentinels


def _int_rows(rng, n, d, lo=-4, hi=5):
    """Integer rows whose largest magnitude is 127 (column 0, either sign):
    int8 quantizes them to themselves, with scl 2 (L2) or 1 (IP), and
    every split score is an exact f32 integer."""
    v = rng.integers(lo, hi, size=(n, d)).astype(np.float32)
    v[:, 0] = np.where(rng.random(n) < 0.5, -127.0, 127.0)
    return v


def _jax_tables(v, metric, n_pad, comp_dtype):
    comp, aux = js.pack_split_tables(v, metric, n_pad, comp_dtype=_DT[comp_dtype])
    comp = jnp.asarray(comp)
    if comp_dtype == "bf16":
        comp = comp.astype(jnp.bfloat16)
    return comp, jnp.asarray(aux)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    """f32 as its bits, so that a comparison is bit for bit."""
    return a.view(np.uint32) if a.dtype == np.float32 else a


# --- packing -----------------------------------------------------------------

@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("n,d", [(5000, 16), (4096, 30), (300, 128)])
def test_pack_split_tables_match_jax_bit_for_bit(comp_dtype, metric, n, d):
    v = (np.random.default_rng(n + d).normal(size=(n, d)) * 3).astype(np.float32)
    n_pad = -(-n // ts.SPLIT_QUANTUM) * ts.SPLIT_QUANTUM
    want_c, want_a = js.pack_split_tables(v, metric, n_pad, comp_dtype=_DT[comp_dtype])
    comp, aux = ts.pack_split_tables(v, metric, n_pad, comp_dtype=comp_dtype)
    assert comp.dtype == ts.COMP_DTYPES[comp_dtype]
    assert tuple(comp.shape) == (n_pad, ts.comp_width(d)) and comp.shape[1] % 16 == 0
    got = _np(comp)
    assert got.dtype == want_c.dtype  # f32 holding bf16 values, or int8
    np.testing.assert_array_equal(_bits(got[:, :d]), _bits(want_c[:, :d]))
    assert not got[:, d:].any() and not want_c[:, d:].any()
    np.testing.assert_array_equal(_bits(aux.numpy()), _bits(want_a))


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("metric", [0, 1])
def test_pack_split_device_matches_jax(comp_dtype, metric):
    d = 24
    v = (np.random.default_rng(4 + metric).normal(size=(4096, d)) * 3).astype(np.float32)
    want_c, want_a = js.pack_split_device(jnp.asarray(v), metric=metric, dpc=128,
                                          int8=comp_dtype == "int8")
    comp, aux = ts.pack_split_device(torch.from_numpy(v), metric, comp_dtype=comp_dtype)
    want_c = np.asarray(want_c)
    if comp_dtype == "bf16":
        want_c = want_c.view(np.uint16)
        got_c = comp.view(torch.int16).numpy().view(np.uint16)
    else:
        got_c = comp.numpy()
    np.testing.assert_array_equal(got_c[:, :d], want_c[:, :d])
    assert not got_c[:, d:].any()
    # the norms: f32 row sums in other orders, a few ulps apart
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_a), rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [16, 30])
def test_pack_split_query_matches_jax(d):
    q = np.random.default_rng(d).normal(size=(9, d)).astype(np.float32)
    want = np.asarray(js.pack_split_query(jnp.asarray(q), 128)).view(np.uint16)
    got = ts.pack_split_query(torch.from_numpy(q), ts.comp_width(d))
    got = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got[:, :d], want[:, :d])
    assert not got[:, d:].any()


def test_pad_split_tables_pads_with_never_winning_rows():
    comp, aux = ts.pack_split_device(torch.ones(4096, 16), 0, comp_dtype="int8")
    pc, pa = ts.pad_split_tables(comp, aux, ts.SPLIT_QUANTUM)
    assert pc.shape == (ts.SPLIT_QUANTUM, 16) and pa.shape == (2, ts.SPLIT_QUANTUM)
    assert not pc[4096:].any() and (pa[0, 4096:] == np.float32(ts.NEG)).all()
    assert (pa[1, 4096:] == 1.0).all() and torch.equal(pa[:, :4096], aux)


# --- the K3 twins against the interpret-mode kernels -------------------------

_FNS = {
    "scan": (js.classmax_scan_split, cm.classmax_scan_split, False),
    "topk": (js.classmax_topk_scan_split, cm.classmax_topk_scan_split, True),
}


def _run_both(fn, v, q, metric, comp_dtype, n_pad, cls, kb, keep2):
    jfn, tfn, topk = _FNS[fn]
    kw = {"cls": cls, "keep2": keep2, **({"kb": kb} if topk else {})}
    jc, ja = _jax_tables(v, metric, n_pad, comp_dtype)
    want = jfn(jc, ja, js.pack_split_query(jnp.asarray(q), jc.shape[1]),
               tq=q.shape[0], tn=max(2048, cls), interpret=True, **kw)
    comp, aux = ts.pack_split_tables(v, metric, n_pad, comp_dtype=comp_dtype)
    got = tfn(comp, aux, ts.pack_split_query(torch.from_numpy(q), comp.shape[1]), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("fn", list(_FNS))
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("metric", [0, 1])
def test_twins_match_pallas_bit_for_bit_on_integers(fn, keep2, comp_dtype, metric):
    """Integer rows (column 0 at +-127) and queries in [-4, 4]: every
    score is an exact f32 integer and ties are frequent, so the tie rules
    and keep2's demotion show; 700 pad rows never enter."""
    rng = np.random.default_rng(metric + 2 * keep2)
    n_pad, d, cls, kb = 8192, 32, 256, 16
    v = _int_rows(rng, n_pad - 700, d)
    q = rng.integers(-4, 5, size=(B, d)).astype(np.float32)
    want, got = _run_both(fn, v, q, metric, comp_dtype, n_pad, cls, kb, keep2)
    assert len(want) == len(got) == (4 if keep2 else 2)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    if fn == "scan":  # ties really occur: many classes share a best score
        assert (want[0][:, :, None] == want[0][:, None, :]).sum() > B * cls


@pytest.mark.parametrize("fn", list(_FNS))
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_twins_match_pallas_on_gaussians(fn, keep2, comp_dtype):
    """Gaussian rows: scores agree to GAUSS_ATOL; rows agree wherever the
    class winner beats its runner-up by more than that."""
    rng = np.random.default_rng(50 + keep2)
    n_pad, d, cls, kb = 8192, 48, 512, 32
    v = rng.normal(size=(n_pad - 100, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    want, got = _run_both(fn, v, q, 0, comp_dtype, n_pad, cls, kb, keep2)
    for w, g in zip(want[::2], got[::2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=GAUSS_ATOL)
    if fn == "scan":
        comp, aux = ts.pack_split_tables(v, 0, n_pad, comp_dtype=comp_dtype)
        qq = ts.pack_split_query(torch.from_numpy(q), comp.shape[1])
        twin = cm.classmax_scan_split_ref(comp, aux, qq, cls=cls, keep2=True)
        clear = (twin[0] - twin[2]).numpy() > GAUSS_ATOL
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(got[1][clear], want[1][clear])


@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_fused_equals_unfused_plus_select(keep2, comp_dtype):
    rng = np.random.default_rng(9)
    comp, aux = ts.pack_split_tables(_int_rows(rng, 4000, 32), 0, 4096,
                                     comp_dtype=comp_dtype)
    q = ts.pack_split_query(torch.from_numpy(
        rng.integers(-4, 5, size=(B, 32)).astype(np.float32)), 32)
    unfused = cm.classmax_scan_split(comp, aux, q, cls=512, keep2=keep2)
    fused = cm.classmax_topk_scan_split(comp, aux, q, cls=512, kb=24, keep2=keep2)
    vals, sel = cm.select_lanes(unfused[0], 24)
    assert torch.equal(fused[0], vals)
    for f, u in zip(fused[1:], unfused[1:]):
        assert torch.equal(f, torch.gather(u, 1, sel))


def test_empty_classes_keep_the_start_state():
    """A class with only pad rows keeps (NEG, row = lane), as in Pallas."""
    rng = np.random.default_rng(5)
    v = _int_rows(rng, 700, 16)
    q = rng.integers(-4, 5, size=(B, 16)).astype(np.float32)
    want, got = _run_both("scan", v, q, 0, "int8", 2048, 1024, 0, True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[0][:, 700:] == np.float32(ts.NEG)).all()
    np.testing.assert_array_equal(got[1][:, 700:],
                                  np.broadcast_to(np.arange(700, 1024), (B, 324)))


def test_cpu_wrappers_launch_nothing_and_empty_batches():
    comp, aux = ts.pack_split_tables(_int_rows(np.random.default_rng(1), 4096, 16),
                                     0, 4096, comp_dtype="int8")
    q = torch.zeros(8, 16, dtype=torch.bfloat16)
    fns = (cm.classmax_scan_split, cm.classmax_topk_scan_split)
    before = [(f.launches, dict(f.form_launches)) for f in fns]
    got = cm.classmax_scan_split(comp, aux, q, cls=256, keep2=True)
    want = cm.classmax_scan_split_ref(comp, aux, q, cls=256, keep2=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    empty = cm.classmax_topk_scan_split(comp, aux, q[:0], cls=256, kb=8)
    assert [tuple(e.shape) for e in empty] == [(0, 8), (0, 8)]
    assert before == [(f.launches, dict(f.form_launches)) for f in fns]


@pytest.mark.parametrize("bad", ["f16_comp", "aux_shape", "aux_f64", "q_f32",
                                 "width", "rows_per_class", "kb_over", "meta"])
def test_split_wrappers_reject(bad):
    comp = torch.zeros(2048, 32, dtype=torch.int8)
    aux = torch.ones(2, 2048)
    q = torch.zeros(4, 32, dtype=torch.bfloat16)
    fn, kw = cm.classmax_scan_split, {"cls": 256}
    if bad == "f16_comp":
        comp = comp.half()
    elif bad == "aux_shape":
        aux = torch.ones(2, 1024)
    elif bad == "aux_f64":
        aux = aux.double()
    elif bad == "q_f32":
        q = q.float()
    elif bad == "width":
        q = torch.zeros(4, 48, dtype=torch.bfloat16)
    elif bad == "rows_per_class":
        kw = {"cls": 3000}
    elif bad == "kb_over":
        fn, kw = cm.classmax_topk_scan_split, {"cls": 256, "kb": 257}
    elif bad == "meta":
        comp, aux, q = comp.to("meta"), aux.to("meta"), q.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fn(comp, aux, q, **kw)


# --- the split re-ranks ------------------------------------------------------

def _cands(rng, n, K):
    ids = rng.integers(0, n, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.15] = -1
    ids[:, 1] = ids[:, 0]  # duplicates
    return ids


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("metric", [0, 1])
def test_rerank_topk_split_and_prerank_trim_match_jax(comp_dtype, metric):
    rng = np.random.default_rng(7 + metric)
    n, d, K, k = 500, 16, 48, 10
    v = _int_rows(rng, n, d)
    q = rng.integers(-4, 5, size=(B, d)).astype(np.float32)
    ids = _cands(rng, n, K)
    jc, ja = _jax_tables(v, metric, 4096, comp_dtype)
    comp, aux = ts.pack_split_tables(v, metric, 4096, comp_dtype=comp_dtype)
    tq, tids = torch.from_numpy(q), torch.from_numpy(ids)
    wd, wi = jd.rerank_topk_split(jc, ja, jnp.asarray(q), jnp.asarray(ids), k, metric)
    gd, gi = td.rerank_topk_split(comp, aux, tq, tids, k, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for pre in (5, 20):
        want = jd.prerank_trim_split(jc, ja, jnp.asarray(q), jnp.asarray(ids), pre)
        got = td.prerank_trim_split(comp, aux, tq, tids, pre)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_rerank_topk_split_gaussian(comp_dtype):
    rng = np.random.default_rng(11)
    n, d, K, k = 700, 24, 40, 10
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = _cands(rng, n, K)
    jc, ja = _jax_tables(v, 0, 4096, comp_dtype)
    comp, aux = ts.pack_split_tables(v, 0, 4096, comp_dtype=comp_dtype)
    wd, wi = jd.rerank_topk_split(jc, ja, jnp.asarray(q), jnp.asarray(ids), k, 0)
    gd, gi = td.rerank_topk_split(comp, aux, torch.from_numpy(q),
                                  torch.from_numpy(ids), k, 0)
    assert (gi.numpy() == np.asarray(wi)).mean() > 0.98
    same = gi.numpy() == np.asarray(wi)
    np.testing.assert_allclose(gd.numpy()[same], np.asarray(wd)[same],
                               rtol=RTOL, atol=ATOL)


# --- SplitFlatIndex ----------------------------------------------------------

# (kb, keep2, fused) of each scan route
_ROUTES = [(16, False, False), (16, False, True), (16, True, False), (16, True, True)]


@pytest.fixture(scope="module")
def int_case():
    """Integer rows (column 0 at +-127) and queries near them: every scan
    score and distance is exact in both packages, for bf16 and int8."""
    rng = np.random.default_rng(21)
    base = _int_rows(rng, 7000, 16)
    queries = base[rng.integers(0, 7000, 40)] + rng.integers(-1, 2, size=(40, 16))
    return base, queries.astype(np.float32)


@pytest.fixture(scope="module")
def jax_indexes(int_case):
    base, _ = int_case
    return {dt: jf.SplitFlatIndex(base, comp_dtype=dt, interpret=True)
            for dt in ("bf16", "int8")}


def _search_both(jidx, idx, queries, **kw):
    want_i, want_d = jidx.search(queries, 10, **kw)
    got_i, got_d = idx.search(queries, 10, batch_size=32, **kw)
    return want_i, want_d, got_i, got_d


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kb,keep2,fused", _ROUTES)
def test_splitflat_routes_match_jax(int_case, jax_indexes, comp_dtype, kb, keep2,
                                    fused):
    base, queries = int_case
    jidx = jax_indexes[comp_dtype]
    idx = SplitFlatIndex(base, comp_dtype=comp_dtype, device="cpu")
    np.testing.assert_array_equal(idx.perm, jidx.perm)
    want_i, want_d, got_i, got_d = _search_both(
        jidx, idx, queries, kb=kb, cls=256, keep2=keep2, fused_sel=fused)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_splitflat_prerank_and_no_dists_match_jax(int_case, jax_indexes, comp_dtype):
    base, queries = int_case
    jidx = jax_indexes[comp_dtype]
    idx = SplitFlatIndex(base, comp_dtype=comp_dtype, device="cpu")
    kw = dict(kb=16, cls=256, keep2=True, prerank=12)
    want_i, want_d, got_i, got_d = _search_both(jidx, idx, queries, **kw)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    want_i, _, got_i, got_d = _search_both(jidx, idx, queries, with_dists=False, **kw)
    np.testing.assert_array_equal(got_i, want_i)
    assert not got_d.any()


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("keep_base", [True, False])
def test_splitflat_from_device_matches_jax(int_case, comp_dtype, keep_base):
    base, queries = int_case
    v = base[:4096]
    jidx = jf.SplitFlatIndex.from_device(jnp.asarray(v), comp_dtype=comp_dtype,
                                         keep_base=keep_base)
    idx = SplitFlatIndex.from_device(torch.from_numpy(v), comp_dtype=comp_dtype,
                                     keep_base=keep_base)
    assert idx.comp.shape[0] == ts.SPLIT_QUANTUM and idx.perm is None
    assert (idx.vectors is None) == (not keep_base)
    for kb, keep2, fused in _ROUTES[::3]:
        want_i, want_d, got_i, got_d = _search_both(
            jidx, idx, queries, kb=kb, cls=256, keep2=keep2, fused_sel=fused)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_splitflat_from_parts_matches_jax(int_case, comp_dtype):
    """Table-only: the re-rank reads the split tables."""
    base, queries = int_case
    v = base[:6000]
    jc, ja = _jax_tables(v, 0, 8192, comp_dtype)
    jidx = jf.SplitFlatIndex.from_parts(jc, ja, 6000, dim=16)
    comp, aux = ts.pack_split_tables(v, 0, 8192, comp_dtype=comp_dtype)
    idx = SplitFlatIndex.from_parts(comp, aux, 6000, dim=16)
    assert idx.vectors is None and idx.comp_dtype == comp_dtype
    for kb, keep2, fused in _ROUTES:
        want_i, want_d, got_i, got_d = _search_both(
            jidx, idx, queries, kb=kb, cls=256, keep2=keep2, fused_sel=fused)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)


def test_splitflat_from_parts_refuses_bad_tables():
    # the working path: a row-keyed set's tables with its row source
    from shine_tpu_torch.io.device_synth import device_rowkeyed_split_dataset

    rk = device_rowkeyed_split_dataset(n=16_384, dim=16, num_queries=32, seed=2,
                                       num_clusters=8, device="cpu")
    rs_idx = SplitFlatIndex.from_parts(rk.comp_dev, rk.aux_dev, rk.n, dim=16,
                                       row_source=rk.row_source)
    assert rs_idx.row_source is rk.row_source and rs_idx.vectors is None
    assert recall_at_k(rs_idx.search(rk.queries, 10)[0], rk.ground_truth, 10) > 0.97
    comp, aux = ts.pack_split_tables(np.ones((5000, 16), np.float32), 0, 8192)
    with pytest.raises(ValueError, match="pad rows"):  # a real row past n
        SplitFlatIndex.from_parts(comp, aux, 4000)
    with pytest.raises(ValueError):
        SplitFlatIndex.from_parts(comp, aux[:, :4096], 5000)
    with pytest.raises(ValueError):
        SplitFlatIndex.from_parts(comp[:5000], aux[:, :5000], 5000)
    with pytest.raises(TypeError):
        SplitFlatIndex.from_parts(comp.float(), aux, 5000)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_splitflat_from_jax_serves_the_jax_state(int_case, jax_indexes, comp_dtype):
    base, queries = int_case
    jidx = jax_indexes[comp_dtype]
    arrays = {"comp": np.asarray(jidx.comp), "aux": np.asarray(jidx.aux),
              "vectors": np.asarray(jidx.vectors),
              "sqnorms": np.asarray(jidx.sqnorms), "perm": jidx.perm}
    conv = splitflat_from_jax(arrays, n=jidx.n, dim=jidx.dim, metric="l2",
                              device="cpu")
    own = SplitFlatIndex(base, comp_dtype=comp_dtype, device="cpu")
    assert conv.comp_dtype == comp_dtype
    assert torch.equal(conv.comp.view(torch.int8), own.comp.view(torch.int8))
    assert torch.equal(conv.aux, own.aux)
    kw = dict(kb=16, cls=256, keep2=True)
    want_i, _ = jidx.search(queries, 10, **kw)
    got_i, _ = conv.search(queries, 10, **kw)
    np.testing.assert_array_equal(got_i, want_i)
    table_only = splitflat_from_jax({"comp": arrays["comp"], "aux": arrays["aux"],
                                     "perm": jidx.perm}, n=jidx.n, dim=jidx.dim,
                                    metric="l2", device="cpu")
    assert table_only.vectors is None
    ids, _ = table_only.search(queries, 10, **kw)
    assert recall_at_k(ids, got_i, 10) > 0.9


def test_splitflat_from_jax_rejects_nonzero_padding():
    comp = np.zeros((4096, 128), np.int8)
    comp[0, 100] = 1
    with pytest.raises(ValueError, match="must be zero"):
        splitflat_from_jax({"comp": comp, "aux": np.zeros((2, 4096), np.float32)},
                           n=4096, dim=16, metric="l2", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_splitflat_recall_against_brute_force(metric, comp_dtype):
    ds = synthetic_dataset(n=8192, dim=32, num_queries=64, seed=5, metric=metric)
    idx = SplitFlatIndex(ds.base, metric=metric, comp_dtype=comp_dtype, device="cpu")
    assert idx._resolve_knobs(0, 0, None, None, False) == (32, 2048, False, False)
    ids, dists = idx.search(ds.queries, 10)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.97
    assert np.all(np.diff(dists, axis=1) >= 0)


def _fake_jax_index(n_pad, exact):
    """A JAX SplitFlatIndex of n_pad x 128 rows that holds no table: its
    search resolves the knobs, then calls ``split_flat_search_at``."""
    j = jf.SplitFlatIndex.__new__(jf.SplitFlatIndex)
    j.comp = j.aux = types.SimpleNamespace(shape=(n_pad, 128))
    j.vectors = j.sqnorms = types.SimpleNamespace() if exact else None
    j.row_source = j.perm = None
    j.n, j.dim, j.metric, j.interpret = n_pad, 128, 0, True
    return j


@pytest.mark.parametrize("n_pad", [1_015_808, 1_032_192])
@pytest.mark.parametrize("exact", [True, False])
def test_resolve_knobs_match_jax(monkeypatch, n_pad, exact):
    seen = []

    def capture(*args, k, kb, cls, keep2, fused_sel, batch, **kw):
        seen.append((kb, cls, keep2, fused_sel))
        return jnp.zeros((batch, k)), jnp.zeros((batch, k), jnp.int32)

    monkeypatch.setattr(jf, "split_flat_search_at", capture)
    j = _fake_jax_index(n_pad, exact)
    idx = SplitFlatIndex.__new__(SplitFlatIndex)
    idx.comp = torch.empty((n_pad, 128), dtype=torch.int8, device="meta")
    idx.vectors = torch.empty(0) if exact else None
    idx.dim = 128
    q = np.zeros((4, 128), np.float32)
    for knobs in ({}, {"kb": 32, "keep2": True}, {"kb": 64, "keep2": True},
                  {"kb": 16}, {"cls": 1024}):
        j.search(q, 10, **knobs)
        got = idx._resolve_knobs(knobs.get("kb", 0), knobs.get("cls", 0),
                                 knobs.get("keep2"), None, False)
        assert got == seen[-1], knobs
    if exact:  # past n_pad = 1,024,000 the auto rule takes cls=4096
        assert seen[0][1] == (4096 if n_pad > 1_024_000 else 2048)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_cost_counters_match_jax(comp_dtype):
    v = np.random.default_rng(2).normal(size=(5000, 128)).astype(np.float32)
    want = jf.SplitFlatIndex(v, comp_dtype=comp_dtype, interpret=True)
    got = SplitFlatIndex(v, comp_dtype=comp_dtype, device="cpu")
    for nq, kb in ((10_000, 0), (100, 64)):
        assert got.cost_counters(nq, kb=kb) == want.cost_counters(nq, kb=kb)


def test_cpu_search_launches_no_kernel():
    ds = synthetic_dataset(n=4096, dim=16, num_queries=8, seed=4, compute_gt=False)
    fns = (cm.classmax_scan_split, cm.classmax_topk_scan_split)
    before = [f.launches for f in fns]
    for knobs in ({}, {"kb": 8, "keep2": True}):
        SplitFlatIndex(ds.base, comp_dtype="int8", device="cpu").search(
            ds.queries, 5, **knobs)
    assert before == [f.launches for f in fns]
