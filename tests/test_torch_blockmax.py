"""The block-max scans (shine_tpu_torch.ops.blockmax: K5 and K6) and
FastFlatIndex's block-max route against the JAX package: K5's and K6's
twins against ``blockmax_scan`` and ``blockmax_scan2`` run in interpret
mode, and the port's ``blockmax`` route against the JAX FastFlatIndex under
``interpret=True``, the route it takes on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.models import flat as jf
from shine_tpu.ops import pallas_scan as j5
from shine_tpu.ops import pallas_scan2 as j6
from shine_tpu_torch import FastFlatIndex, fastflat_from_jax
from shine_tpu_torch.io import synthetic_dataset
from shine_tpu_torch.models import flat as tf
from shine_tpu_torch.ops import blockmax as bm
from shine_tpu_torch.ops.scan import pack_ext_query, pack_ext_table

# Gaussian scores: 2<q, v> - |v|^2 at d <= 254 with |q|, |v| ~ sqrt(d), summed
# in other orders by XLA and torch: a few ulps of terms up to ~1e3, so 5e-3
SCORE_ATOL = 5e-3
# distances of O(1e2) summed in other orders by the two frameworks
RTOL, ATOL = 1e-5, 1e-3


def _tables(rng, n, d, metric, n_pad, integer):
    """The JAX and port packed tables of one row set, and one query set
    packed for each: integer rows with repeated rows (in-block ties) and
    pad blocks, or Gaussian rows."""
    if integer:
        v = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        v[40:48] = v[39]  # ties inside a block
        v[200] = v[7]  # ties across blocks
        q = rng.integers(-3, 4, size=(96, d)).astype(np.float32)
    else:
        v = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(96, d)).astype(np.float32)
    j_ext = jnp.asarray(j5.pack_ext_table(v, metric, n_pad), jnp.bfloat16)
    j_q = j5.pack_ext_query(jnp.asarray(q), j_ext.shape[1]).astype(jnp.bfloat16)
    t_ext = pack_ext_table(v, metric, n_pad)
    t_q = pack_ext_query(torch.from_numpy(q), t_ext.shape[1]).to(torch.bfloat16)
    return (j_ext, j_q), (t_ext, t_q)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("d", [128, 254])  # port widths 144 and 256
def test_blockmax_twins_match_jax_bit_for_bit(metric, d):
    rng = np.random.default_rng(d + metric)
    n, n_pad = 5000, 8192  # 24 blocks of pad rows, one block half pad
    (j_ext, j_q), (t_ext, t_q) = _tables(rng, n, d, metric, n_pad, True)
    assert t_ext.shape[1] == (144 if d == 128 else 256)
    want = j5.blockmax_scan(j_ext, j_q, tq=96, tn=1024, interpret=True)
    got = bm.blockmax_scan(t_ext, t_q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    # the pad blocks: (bf16(NEG), first row) then (NEG, the same row)
    pad = slice(n // 128 + 1, None)
    assert (got[0][:, pad] < -3e38).all() and (got[2][:, pad] == np.float32(-3e38)).all()
    assert torch.equal(got[1][:, pad], got[3][:, pad])
    want2 = j6.blockmax_scan2(j_ext, j_q, tq=96, interpret=True)
    got2 = bm.blockmax_scan2(t_ext, t_q)
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("metric", [0, 1])
def test_blockmax_twins_gaussian(metric):
    rng = np.random.default_rng(50 + metric)
    (j_ext, j_q), (t_ext, t_q) = _tables(rng, 7000, 64, metric, 8192, False)
    want = [np.asarray(w) for w in j5.blockmax_scan(j_ext, j_q, tq=96, tn=1024,
                                                     interpret=True)]
    got = [g.numpy() for g in bm.blockmax_scan(t_ext, t_q)]
    for plane in (0, 2):
        np.testing.assert_allclose(got[plane], want[plane], rtol=0, atol=SCORE_ATOL)
    clear = (want[0] - want[2]) > 2 * SCORE_ATOL
    np.testing.assert_array_equal(got[1][clear], want[1][clear])
    want2 = [np.asarray(w) for w in j6.blockmax_scan2(j_ext, j_q, tq=96,
                                                       interpret=True)]
    got2 = [g.numpy() for g in bm.blockmax_scan2(t_ext, t_q)]
    np.testing.assert_allclose(got2[0], want2[0], rtol=0, atol=SCORE_ATOL)
    assert (got2[1] == want2[1]).mean() > 0.99
    assert j6.group_rows() == bm.group_rows() == 4096


def test_blockmax_wrappers_refuse_bad_inputs():
    ext = torch.zeros((4096, 32), dtype=torch.bfloat16)
    q = torch.zeros((4, 32), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        bm.blockmax_scan(ext.float(), q)
    with pytest.raises(ValueError):
        bm.blockmax_scan(ext[:100], q)
    with pytest.raises(ValueError):
        bm.blockmax_scan2(ext[:2048], q)
    with pytest.raises(ValueError):
        bm.blockmax_scan(ext, q[:, :16].contiguous())
    bm.blockmax_scan.launches = bm.blockmax_scan2.launches = 0
    bm.blockmax_scan(ext, q)
    bm.blockmax_scan2(ext, q)
    assert bm.blockmax_scan.launches == bm.blockmax_scan2.launches == 0


@pytest.fixture(scope="module", params=["l2", "ip"])
def cases(request):
    """Integer rows and queries (every score and distance exact in both
    packages) and a Gaussian set, with their JAX interpret-mode indexes."""
    metric = request.param
    rng = np.random.default_rng(3 if metric == "l2" else 4)
    ints = rng.integers(-4, 5, size=(7000, 16)).astype(np.float32)
    int_q = ints[rng.integers(0, 7000, 40)] + rng.integers(-1, 2, size=(40, 16))
    ds = synthetic_dataset(n=6000, dim=24, num_queries=40, seed=9, metric=metric,
                           compute_gt=False)
    return metric, {
        "int": (ints, int_q.astype(np.float32),
                jf.FastFlatIndex(ints, metric, interpret=True)),
        "gauss": (ds.base, ds.queries,
                  jf.FastFlatIndex(ds.base, metric, interpret=True)),
    }


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("prerank", [0, 12])
def test_blockmax_fastflat_matches_jax_interpret(cases, kind, prerank):
    metric, sets = cases
    base, queries, jidx = sets[kind]
    kw = dict(kb=8, prerank=prerank, batch_size=32)
    want_i, want_d = jidx.search(queries, 10, **kw)
    idx = FastFlatIndex(base, metric, blockmax=True, device="cpu")
    got_i, got_d = idx.search(queries, 10, **kw)
    np.testing.assert_array_equal(got_i, want_i)
    if kind == "int":
        np.testing.assert_array_equal(got_d, want_d)
    else:
        np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)


def test_blockmax_fast_flat_search_one_batch(cases):
    """The batch function itself, on the JAX index's own arrays."""
    metric, sets = cases
    base, queries, jidx = sets["int"]
    q = jnp.asarray(queries)
    j_qe = j5.pack_ext_query(q, jidx.ext.shape[1]).astype(jnp.bfloat16)
    want_d, want_i = jf.fast_flat_search(
        jidx.ext, jidx.vectors, jidx.sqnorms, j_qe, q, k=10, kb=6, tq=40, tn=1024,
        cls=1024, metric=jidx.metric, interpret=True, n=jidx.n, prerank=8)
    idx = FastFlatIndex(base, metric, blockmax=True, device="cpu")
    t_q = torch.from_numpy(queries)
    t_qe = pack_ext_query(t_q, idx.dp).to(torch.bfloat16)
    got_d, got_i = tf.fast_flat_search(
        idx.ext, idx.vectors, idx.sqnorms, t_qe, t_q, k=10, kb=6, tq=40, tn=1024,
        cls=1024, metric=idx.metric, n=idx.n, prerank=8, blockmax=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_fastflat_from_jax_carries_the_blockmax_flag(cases):
    metric, sets = cases
    base, queries, jidx = sets["int"]
    arrays = {"ext": np.asarray(jidx.ext), "vectors": np.asarray(jidx.vectors),
              "sqnorms": np.asarray(jidx.sqnorms), "perm": jidx.perm,
              "interpret": jidx.interpret}
    conv = fastflat_from_jax(arrays, n=jidx.n, dim=jidx.dim, metric=metric,
                             device="cpu")
    assert conv.blockmax
    want_i, _ = jidx.search(queries, 10, kb=8)
    got_i, _ = conv.search(queries, 10, kb=8)
    np.testing.assert_array_equal(got_i, want_i)
    plain = fastflat_from_jax({k: v for k, v in arrays.items() if k != "interpret"},
                              n=jidx.n, dim=jidx.dim, metric=metric, device="cpu")
    assert not plain.blockmax  # the class-max route, as the port's own index
    own = FastFlatIndex(base, metric, device="cpu")
    np.testing.assert_array_equal(plain.search(queries, 10)[0],
                                  own.search(queries, 10)[0])


def test_blockmax_route_launches_no_kernel_on_the_cpu(cases):
    metric, sets = cases
    base, queries, _ = sets["gauss"]
    bm.blockmax_scan.launches = 0
    idx = FastFlatIndex(base, metric, blockmax=True, device="cpu")
    idx.search(queries, 10)
    assert bm.blockmax_scan.launches == 0
