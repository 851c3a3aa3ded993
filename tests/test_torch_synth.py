"""The row-keyed capacity path of the port against the JAX package, on the
CPU: ``ops/threefry.py`` against ``jax.random``, ``ops/regen.py`` and
``io/device_synth.py`` against ``shine_tpu/io/device_synth.py``,
``regen_rerank_topk`` against ``shine_tpu/ops/distance.py``, the recall
helpers against ``shine_tpu/io/recall.py``, and the three indexes that take
a ``row_source`` (FastFlat, SplitFlat, RoutedSplit) and the routed
checkpoint against the JAX package's.

Bit for bit: keys, split keys, random bits, uniforms, ``randint`` and each
row's cluster draw. Within a stated bound: the normals, whose ``log1p`` is
XLA's f32 one in JAX, up to 2 ulps from the correctly rounded one torch
gives (so ``erf_inv`` within 2 ulps, a normal, times sqrt(2), within 3);
the rows and everything summed from them. On the CPU the wrappers run
their plain versions; the CUDA kernels are held against those in
tests/test_torch_kernel.py, on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.io import checkpoint as jc
from shine_tpu.io import device_synth as jds
from shine_tpu.io import recall as jrec
from shine_tpu.models import flat as jf
from shine_tpu.models import routed_split as jrs
from shine_tpu.ops import distance as jd
from shine_tpu_torch import (
    FastFlatIndex,
    RoutedSplitIndex,
    SplitFlatIndex,
    build_routed_split,
    fastflat_from_jax,
    routed_split_from_jax,
    row_source_from_jax,
    splitflat_from_jax,
)
from shine_tpu_torch.io import (
    brute_force_knn,
    gt_crosscheck,
    load_routed_split,
    margin_mask,
    numpy_subset_gt,
    recall_at_k,
    recall_at_k_eps,
    recall_at_k_eps_regen,
    save_routed_split,
)
from shine_tpu_torch.io import device_synth as tds
from shine_tpu_torch.models import ivf as tivf
from shine_tpu_torch.models import routed_split as trs
from shine_tpu_torch.ops import distance as td
from shine_tpu_torch.ops import regen
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.parallel import placement as tpl
from shine_tpu_torch.parallel import shard_mesh

# a row's values: c[a] + a normal, within 4 ulps of the row's norm (the
# normal's 3, and the sum's rounding); unit rows (IP) add the norm's sum
ROW_ULPS = 4
MIN_GT_OVERLAP = 0.999
GT_SWAP_RTOL = 1e-5
MIN_ID_OVERLAP = 0.99
# codes of the packed tables: a row value a few ulps off can round to the
# next bf16 or int8 step; at most this share of the codes may
MAX_STEP_SHARE = 1e-3
N, D, NQ = 65_536, 16, 128


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _within_row_ulps(got: np.ndarray, want: np.ndarray, ulps: int = ROW_ULPS) -> None:
    scale = np.spacing(np.linalg.norm(want, axis=1).astype(np.float32))[:, None]
    assert (np.abs(got - want) <= ulps * scale).all(), np.max(np.abs(got - want) / scale)


def _rs_jax(seed=17, nc=64, d=D):
    k0, k1, _, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    return k1, jax.random.normal(k0, (nc, d), jnp.float32) * 4.0


def _rs_port(k1, centers):
    return row_source_from_jax(np.asarray(k1), np.asarray(centers), device="cpu")


# --- ops/threefry.py: jax.random, bit for bit ---------------------------------

@pytest.mark.parametrize("seed", [0, 17, 1234, 2**31 + 5])
def test_keys_fold_in_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for data in (0, 1, 12_345, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(tf.fold_in(tk, data).numpy(),
                                      _u32(jax.random.fold_in(jk, data)))
    for num in (2, 4):
        np.testing.assert_array_equal(tf.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    ids = np.arange(0, 5000, 7)
    kk = jax.vmap(lambda i: jax.random.fold_in(jk, i))(ids)
    got = tf.fold_in(tk, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), _u32(kk))
    np.testing.assert_array_equal(tf.split(got).numpy(), _u32(jax.vmap(jax.random.split)(kk)))


@pytest.mark.parametrize("shape", [(), (128,), (7, 33)])
def test_random_bits(shape):
    for seed in (3, 99):
        want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
        np.testing.assert_array_equal(tf.random_bits32(tf.prng_key(seed), shape).numpy(),
                                      _u32(want))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.5, 3.0), (-0.99999994, 1.0)])
def test_uniform(bounds):
    want = jax.random.uniform(jax.random.PRNGKey(5), (4096,), jnp.float32, *bounds)
    got = tf.uniform(tf.prng_key(5), (4096,), *bounds)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("span", [1, 7, 64, 2**20])
def test_randint(span):
    for lo in (0, 3):
        want = jax.random.randint(jax.random.PRNGKey(11), (2000,), lo, lo + span)
        got = tf.randint(tf.prng_key(11), (2000,), lo, lo + span)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    keys = jax.random.split(jax.random.PRNGKey(2), 300)
    want = jax.vmap(lambda k: jax.random.randint(k, (), 0, span))(keys)
    np.testing.assert_array_equal(tf.randint(torch.from_numpy(_u32(keys)), (), 0, span).numpy(),
                                  np.asarray(want).astype(np.int64))


def test_normal_within_ulps():
    """2^18 draws: the uniforms bit for bit, erf_inv within 2 ulps of XLA's
    on them and a normal within 3 (XLA's log1p), >= 98% bit-equal."""
    n = 1 << 18
    jk, tk = jax.random.PRNGKey(17), tf.prng_key(17)
    u = tf.uniform(tk, (n,), -0.99999994, 1.0)
    want_u = jax.random.uniform(jk, (n,), jnp.float32, np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))
    e = _ulps(tf.erf_inv(u).numpy(), np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy()))))
    assert e.max() <= 2
    z = _ulps(tf.normal(tk, (n,)).numpy(), np.asarray(jax.random.normal(jk, (n,), jnp.float32)))
    assert z.max() <= 3
    assert (z == 0).mean() > 0.98, (z == 0).mean()
    assert (_ulps(torch.erfinv(u).numpy(), np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy()))))
            .max() > 2)  # torch's own erfinv is not XLA's


# --- regen_rows ---------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_regen_rows_match_jax(metric):
    k1, centers = _rs_jax(d=32)
    ids = np.arange(3, 40_000, 5).astype(np.int32)
    norm = metric == "ip"
    want = np.asarray(jds.regen_rows(k1, centers, jnp.asarray(ids), normalize=norm))
    key, cents = _rs_port(k1, centers)
    got = regen.regen_rows(key, cents, torch.from_numpy(ids), normalize=norm).numpy()
    _within_row_ulps(got, want)
    # the cluster draw, bit for bit
    want_a = jax.vmap(lambda i: jax.random.randint(
        jax.random.split(jax.random.fold_in(k1, i))[0], (), 0, 64))(ids)
    kk = tf.split(tf.fold_in(key, torch.from_numpy(ids.astype(np.int64))))
    np.testing.assert_array_equal(tf.randint(kk[:, 0], (), 0, 64).numpy(),
                                  np.asarray(want_a).astype(np.int64))
    # the plain version and the wrapper are one function on the CPU
    np.testing.assert_array_equal(
        regen.regen_rows_ref(key, cents, torch.from_numpy(ids), normalize=norm).numpy(), got)


def test_regen_wrappers_check_their_inputs():
    key, cents = _rs_port(*_rs_jax())
    with pytest.raises(ValueError):
        regen.regen_rows(key[:1], cents, torch.arange(4))
    with pytest.raises(TypeError):
        regen.regen_rows(key, cents.double(), torch.arange(4))
    with pytest.raises(ValueError, match="2\\^31"):
        regen.regen_rows(key, cents, torch.tensor([3, 2**31]))
    with pytest.raises(TypeError):
        regen.regen_score(key, cents, torch.zeros(2, D), torch.zeros(2, 3), 0)
    out = regen.regen_score(key, cents, torch.zeros(2, D),
                            torch.tensor([[0, -1, 5], [-1, -1, 2]], dtype=torch.int32), 0)
    assert torch.isinf(out[0, 1]) and torch.isinf(out[1, :2]).all()
    assert torch.isfinite(out[0, [0, 2]]).all()


# --- the row-keyed datasets ---------------------------------------------------

@pytest.fixture(scope="module")
def split_sets():
    out = {}
    for comp_dtype, metric in (("int8", "l2"), ("bf16", "l2"), ("int8", "ip")):
        kw = dict(n=N, dim=D, num_queries=NQ, metric=metric, seed=5, gt_k=11,
                  comp_dtype=comp_dtype, num_clusters=16)
        out[comp_dtype, metric] = (jds.device_rowkeyed_split_dataset(**kw),
                                   tds.device_rowkeyed_split_dataset(**kw, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ext_sets():
    out = {}
    for metric in ("l2", "ip"):
        kw = dict(n=N, dim=D, num_queries=NQ, metric=metric, seed=9, gt_k=11,
                  num_clusters=16)
        out[metric] = (jds.device_rowkeyed_ext_dataset(**kw),
                       tds.device_rowkeyed_ext_dataset(**kw, device="cpu"))
    return out


def _check_gt(want_ds, got_ds, metric: str) -> None:
    """>= 99.9% of the ground-truth ids equal; a swapped id only where its
    exact distance is within GT_SWAP_RTOL of the k-th's."""
    want, got = np.asarray(want_ds.ground_truth), got_ds.ground_truth
    assert recall_at_k(got, want, want.shape[1]) >= MIN_GT_OVERLAP
    k1, centers = want_ds.row_source
    q = want_ds.queries.astype(np.float64)
    for i in np.nonzero((np.sort(got, 1) != np.sort(want, 1)).any(1))[0]:
        rows = np.asarray(jds.regen_rows(k1, centers, jnp.asarray(np.concatenate(
            [got[i], want[i]]).astype(np.int32)), normalize=metric == "ip")).astype(np.float64)
        dist = ((rows - q[i]) ** 2).sum(1) if metric == "l2" else 1.0 - rows @ q[i]
        kth = dist[len(got[i]):].max()
        assert np.all(dist[:len(got[i])] <= kth * (1 + GT_SWAP_RTOL) + 1e-6), i


def _codes_close(got: np.ndarray, want: np.ndarray) -> None:
    """Equal codes but for a few one step apart (int8 values, bf16 bits)."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_STEP_SHARE, (diff > 0).mean()


@pytest.mark.parametrize("case", [("int8", "l2"), ("bf16", "l2"), ("int8", "ip")])
def test_rowkeyed_split_dataset_matches_jax(split_sets, case):
    want, got = split_sets[case]
    assert got.n == want.n and got.name == want.name
    _within_row_ulps(got.queries, want.queries)
    _check_gt(want, got, case[1])
    jcomp = np.asarray(want.comp_dev)
    if case[0] == "bf16":
        jcomp, tcomp = jcomp.view(np.uint16), got.comp_dev.view(torch.int16).numpy().view(np.uint16)
    else:
        tcomp = got.comp_dev.numpy()
    _codes_close(tcomp[:, :D], jcomp[:, :D])
    # a row's norm and scale follow its codes: equal where they are
    same = (tcomp[:, :D] == jcomp[:, :D]).all(1)
    np.testing.assert_allclose(got.aux_dev.numpy()[:, same], np.asarray(want.aux_dev)[:, same],
                               rtol=1e-5, atol=1e-6)
    key, cents = got.row_source
    np.testing.assert_array_equal(key.numpy(), _u32(want.row_source[0]))
    np.testing.assert_allclose(cents.numpy(), np.asarray(want.row_source[1]), rtol=0,
                               atol=3 * np.spacing(np.float32(16.0)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rowkeyed_ext_dataset_matches_jax(ext_sets, metric):
    want, got = ext_sets[metric]
    assert got.n == want.n and got.rchunk == want.rchunk
    _within_row_ulps(got.queries, want.queries)
    _check_gt(want, got, metric)
    jext = np.asarray(want.ext_dev)
    text = got.ext_dev.view(torch.int16).numpy().view(np.uint16)
    _codes_close(text[:, :D], jext.view(np.uint16)[:, :D])
    # -||x||^2 over two bf16 columns: its value, not its split, is the row's;
    # the second column rounds the remainder to 8 bits, so the pair holds
    # the norm to ~2^-16 of itself, and norms a few ulps apart within 2^-15
    got_nrm = got.ext_dev[:, D:D + 2].float().sum(1).numpy()
    np.testing.assert_allclose(got_nrm, jext[:, D:D + 2].astype(np.float32).sum(1),
                               rtol=2.0 ** -15)
    _within_row_ulps(got.regen(1).numpy(), np.asarray(want.regen(1)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_chunk_keyed_dataset_matches_jax(metric):
    kw = dict(n=16_384, dim=D, num_queries=64, metric=metric, seed=4, num_clusters=16,
              rchunk=4096)
    want = jds.device_synthetic_dataset(**kw)
    got = tds.device_synthetic_dataset(**kw, device="cpu")
    assert got.n == want.n and got.name == want.name
    _within_row_ulps(got.base_dev.numpy(), np.asarray(want.base_dev))
    _within_row_ulps(got.queries, want.queries)
    assert recall_at_k(got.ground_truth, want.ground_truth, 10) >= MIN_GT_OVERLAP


def test_chunk_keyed_ext_dataset_matches_jax():
    kw = dict(n=16_384, dim=D, num_queries=64, seed=6, num_clusters=16, rchunk=4096)
    want = jds.device_synthetic_ext_dataset(**kw)
    got = tds.device_synthetic_ext_dataset(**kw, device="cpu")
    assert got.n == want.n and got.rchunk == want.rchunk and got.row_source is None
    _within_row_ulps(got.queries, want.queries)
    assert recall_at_k(got.ground_truth, np.asarray(want.ground_truth), 10) >= MIN_GT_OVERLAP
    _codes_close(got.ext_dev.view(torch.int16).numpy().view(np.uint16)[:, :D],
                 np.asarray(want.ext_dev).view(np.uint16)[:, :D])
    _within_row_ulps(got.regen(3).numpy(), np.asarray(want.regen(3)))
    found = want.ground_truth[:, :10]
    assert tds.streaming_eps_recall(got, found, 10) == jds.streaming_eps_recall(want, found, 10)


# --- mesh=: row-sharded ingestion ---------------------------------------------

MESH_S = 4


@pytest.mark.parametrize("case", [("int8", "l2"), ("bf16", "l2"), ("int8", "ip")])
def test_mesh_split_dataset_equals_single_device(split_sets, case):
    """Each shard ingests its row range: the shards' tables, cut from one
    table, and the merged ground truth equal the single-device dataset's,
    bit for bit."""
    _, single = split_sets[case]
    comp_dtype, metric = case
    got = tds.device_rowkeyed_split_dataset(
        n=N, dim=D, num_queries=NQ, metric=metric, seed=5, gt_k=11,
        comp_dtype=comp_dtype, num_clusters=16, mesh=shard_mesh(MESH_S, device="cpu"))
    assert got.n == single.n and len(got.comp_dev) == MESH_S
    assert all(c.shape[0] == N // MESH_S for c in got.comp_dev)
    assert torch.equal(torch.cat(got.comp_dev), single.comp_dev)
    assert torch.equal(torch.cat(got.aux_dev, 1), single.aux_dev)
    np.testing.assert_array_equal(got.ground_truth, single.ground_truth)
    np.testing.assert_array_equal(got.queries, single.queries)


def test_mesh_ext_dataset_equals_single_device(ext_sets):
    _, single = ext_sets["l2"]
    got = tds.device_rowkeyed_ext_dataset(
        n=N, dim=D, num_queries=NQ, metric="l2", seed=9, gt_k=11, num_clusters=16,
        mesh=shard_mesh(MESH_S, device="cpu"))
    assert got.rchunk <= single.rchunk
    assert torch.equal(torch.cat(got.ext_dev).view(torch.int16),
                       single.ext_dev.view(torch.int16))
    np.testing.assert_array_equal(got.ground_truth, single.ground_truth)
    # the regenerator reads rows by global id, whatever the chunking: chunk
    # 1 of the shards' chunking inside the single device's chunk
    lo = got.rchunk % single.rchunk
    assert torch.equal(got.regen(1), single.regen(got.rchunk // single.rchunk)[
        lo:lo + got.rchunk])


@pytest.mark.parametrize("kind", ["split", "ext"])
def test_mesh_dataset_matches_jax_mesh_dataset(kind):
    """The JAX package's mesh dataset against the port's, by the rules above:
    queries within ulps, the ground truth's ids, codes a step apart at most."""
    from shine_tpu.parallel import shard_mesh as jax_mesh

    kw = dict(n=32_768, dim=D, num_queries=64, seed=7, gt_k=10, num_clusters=16,
              rchunk=4096)
    if kind == "split":
        want = jds.device_rowkeyed_split_dataset(**kw, comp_dtype="int8",
                                                 mesh=jax_mesh(MESH_S))
        got = tds.device_rowkeyed_split_dataset(**kw, comp_dtype="int8",
                                                mesh=shard_mesh(MESH_S, device="cpu"))
        jt, tt = np.asarray(want.comp_dev), torch.cat(got.comp_dev).numpy()
    else:
        want = jds.device_rowkeyed_ext_dataset(**kw, mesh=jax_mesh(MESH_S))
        got = tds.device_rowkeyed_ext_dataset(**kw, mesh=shard_mesh(MESH_S, device="cpu"))
        jt = np.asarray(want.ext_dev).view(np.uint16)
        tt = torch.cat(got.ext_dev).view(torch.int16).numpy().view(np.uint16)
    assert got.n == want.n
    _within_row_ulps(got.queries, want.queries)
    _check_gt(want, got, "l2")
    _codes_close(tt[:, :D], jt[:, :D])


def test_streaming_eps_recall_matches_jax(ext_sets):
    want, got = ext_sets["l2"]
    rng = np.random.default_rng(1)
    found = np.asarray(want.ground_truth)[:, :10].copy()
    found[:, 5:] = rng.integers(0, N, size=(NQ, 5))
    a = tds.streaming_eps_recall(got, found, 10)
    b = jds.streaming_eps_recall(want, found, 10)
    assert abs(a - b) <= 1.0 / (NQ * 10)
    assert tds.streaming_eps_recall(got, got.ground_truth, 10) == 1.0


def test_scorer_crosscheck(split_sets):
    _, got = split_sets["int8", "l2"]
    assert tds.rowkeyed_scorer_crosscheck(got.row_source, got.queries, n_sub=32_768,
                                          n_eval=32, rchunk=8192) >= 0.995


# --- regen_rerank_topk and candidate_distance --------------------------------

@pytest.mark.parametrize("metric", [0, 1])
def test_regen_rerank_topk_matches_jax(metric):
    k1, centers = _rs_jax(d=32)
    rng = np.random.default_rng(4)
    B, K = 96, 48
    rows = np.asarray(jds.regen_rows(k1, centers, jnp.arange(0, 4096, dtype=jnp.int32),
                                     normalize=metric == 1))
    q = (rows[rng.integers(0, 4096, B)] + 0.3 * rng.normal(size=(B, 32))).astype(np.float32)
    cand = rng.integers(0, 4096, size=(B, K)).astype(np.int32)
    cand[rng.random((B, K)) < 0.1] = -1
    want_d, want_i = jd.regen_rerank_topk(k1, centers, jnp.asarray(q), jnp.asarray(cand), 10,
                                          metric)
    got_d, got_i = td.regen_rerank_topk(*_rs_port(k1, centers), torch.from_numpy(q),
                                        torch.from_numpy(cand), 10, metric)
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    assert (got_i.numpy() == want_i).mean() >= MIN_ID_OVERLAP
    # ROADMAP C5's IVF rule: rtol 1e-5 plus 8 ulps of the largest |q|^2 + |v|^2
    big = (q ** 2).sum(1).max() + (rows ** 2).sum(1).max()
    same = got_i.numpy() == want_i
    np.testing.assert_allclose(got_d.numpy()[same], want_d[same], rtol=1e-5,
                               atol=8 * np.spacing(np.float32(big)))


@pytest.mark.parametrize("metric", [0, 1])
def test_candidate_distance_matches_jax(metric):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    c = rng.normal(size=(20, 12, 16)).astype(np.float32)
    want = np.asarray(jd.candidate_distance(jnp.asarray(q), jnp.asarray(c), metric))
    got = td.candidate_distance(torch.from_numpy(q), torch.from_numpy(c), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- the recall helpers -------------------------------------------------------

@pytest.fixture(scope="module")
def eps_case():
    k1, centers = _rs_jax(seed=21, nc=8, d=12)
    n, k = 4096, 10
    base = np.asarray(jds.regen_rows(k1, centers, jnp.arange(n, dtype=jnp.int32)))
    rng = np.random.default_rng(3)
    queries = (base[rng.integers(0, n, 64)] + 0.3 * rng.normal(size=(64, 12))).astype(np.float32)
    gt, _ = brute_force_knn(base, queries, k + 1)
    found = gt[:, :k].copy()
    found[:, k // 2:] = rng.integers(0, n, size=(64, k - k // 2))
    return k1, centers, base, queries, gt, found


def test_eps_regen_equals_resident(eps_case):
    """As tests/test_eps_regen.py holds it for the JAX package: the regen
    scorer equals the resident one when the regenerated rows are the base."""
    k1, centers, base, queries, gt, found = eps_case
    rs = _rs_port(k1, centers)
    r_res = recall_at_k_eps(found, queries, torch.from_numpy(base), gt, 10)
    r_rg = recall_at_k_eps_regen(found, queries, rs, gt, 10)
    assert r_rg == r_res
    assert 0.5 <= r_rg <= 1.0
    assert r_res == jrec.recall_at_k_eps(found, queries, jnp.asarray(base), gt, 10)
    assert recall_at_k_eps_regen(gt[:, :10], queries, rs, gt, 10) == 1.0
    assert recall_at_k_eps_regen(found, queries, rs, gt, 10, rtol=1e30) == 1.0


def test_margin_mask_matches_jax(eps_case):
    k1, centers, base, queries, gt, _ = eps_case
    want = jrec.margin_mask(queries, jnp.asarray(base), gt, 10)
    want_rg = jrec.margin_mask(queries, None, gt, 10, row_source=(k1, centers))
    got = margin_mask(queries, torch.from_numpy(base), gt, 10)
    got_rg = margin_mask(queries, None, gt, 10, row_source=_rs_port(k1, centers))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_rg, want_rg)
    np.testing.assert_array_equal(got_rg, got)
    with pytest.raises(ValueError):
        margin_mask(queries, torch.from_numpy(base), gt[:, :10], 10)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_numpy_subset_gt_and_crosscheck_match_jax(eps_case, metric):
    _, _, base, queries, gt, _ = eps_case
    want = jrec.numpy_subset_gt(queries, base, 10, chunk=1000, metric=metric)
    np.testing.assert_array_equal(numpy_subset_gt(queries, base, 10, chunk=1000, metric=metric),
                                  want)
    assert (gt_crosscheck(queries, base, want, 10, n_eval=32, metric=metric)
            == jrec.gt_crosscheck(queries, base, want, 10, n_eval=32, metric=metric) == 1.0)


# --- the indexes with a row source -------------------------------------------

def _ids_agree(got: np.ndarray, want: np.ndarray) -> None:
    assert (got == np.asarray(want)).mean() >= MIN_ID_OVERLAP


@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
def test_splitflat_row_source_serves_the_jax_table(split_sets, comp_dtype):
    want_ds, _ = split_sets[comp_dtype, "l2"]
    jidx = jf.SplitFlatIndex.from_parts(want_ds.comp_dev, want_ds.aux_dev, want_ds.n, dim=D,
                                        row_source=want_ds.row_source)
    idx = splitflat_from_jax({"comp": np.asarray(want_ds.comp_dev),
                              "aux": np.asarray(want_ds.aux_dev)}, n=want_ds.n, dim=D,
                             metric="l2", device="cpu",
                             row_source=_rs_port(*want_ds.row_source))
    assert idx.row_source is not None and idx.vectors is None
    # a row source is an exact re-rank: from 2^20 rows the JAX rule's
    # cls=4096 without keep2, where the tables alone keep keep2
    big = SplitFlatIndex.from_parts(torch.zeros((1 << 20, D), dtype=torch.int8),
                                    torch.zeros(2, 1 << 20), 1 << 20, dim=D,
                                    row_source=idx.row_source)
    assert big._resolve_knobs(0, 0, None, None, False)[1:3] == (4096, False)
    big.row_source = None
    assert big._resolve_knobs(0, 0, None, None, False)[1:3] == (1024, True)
    for kw in ({"kb": 32, "cls": 1024}, {"kb": 16, "cls": 1024, "prerank": 20}):
        want_i, want_d = jidx.search(want_ds.queries, 10, batch_size=64, **kw)
        got_i, got_d = idx.search(want_ds.queries, 10, batch_size=64, **kw)
        _ids_agree(got_i, want_i)
        same = got_i == np.asarray(want_i)
        np.testing.assert_allclose(got_d[same], np.asarray(want_d)[same], rtol=1e-5, atol=1e-3)
    assert recall_at_k(got_i, want_ds.ground_truth, 10) > 0.9


def test_fastflat_row_source_serves_the_jax_table(ext_sets):
    want_ds, _ = ext_sets["l2"]
    jidx = jf.FastFlatIndex.from_ext(want_ds.ext_dev, want_ds.n, dim=D,
                                     row_source=want_ds.row_source)
    idx = fastflat_from_jax({"ext": np.asarray(want_ds.ext_dev), "interpret": jidx.interpret},
                            n=want_ds.n, dim=D, metric="l2", device="cpu",
                            row_source=_rs_port(*want_ds.row_source))
    assert idx.row_source is not None
    for kw in ({"kb": 32}, {"kb": 32, "prerank": 16}):
        want_i, _ = jidx.search(want_ds.queries, 10, batch_size=64, **kw)
        got_i, _ = idx.search(want_ds.queries, 10, batch_size=64, **kw)
        _ids_agree(got_i, want_i)
    assert recall_at_k(got_i, want_ds.ground_truth, 10) > 0.9
    # without the row source the re-rank reads the bf16 table
    plain = FastFlatIndex.from_ext(idx.ext, idx.n, dim=D)
    assert plain.row_source is None


RN, RD = 16_384, 16
ROUTED = dict(cap_target=512, cls=128, train_size=8192, seed=3)


@pytest.fixture(scope="module")
def routed_case():
    k1, centers = _rs_jax(seed=23, nc=16, d=RD)
    queries = np.asarray(jds.regen_rows(k1, centers, jnp.arange(0, RN, 128, dtype=jnp.int32))
                         + 0.3 * jax.random.normal(jax.random.PRNGKey(1), (RN // 128, RD)))
    base = np.asarray(jds.regen_rows(k1, centers, jnp.arange(RN, dtype=jnp.int32)))
    gt, _ = brute_force_knn(base, queries, 10)
    jidx = jrs.build_routed_split(RN, RD, row_source=(k1, centers), **ROUTED)
    return k1, centers, queries, gt, jidx


def _routed_arrays(jidx):
    return {"centroids": np.asarray(jidx.centroids), "comp": np.asarray(jidx.comp),
            "aux_r": np.asarray(jidx.aux_r), "gid": np.asarray(jidx.gid)}


def test_routed_row_source_serves_the_jax_index(routed_case):
    k1, centers, queries, gt, jidx = routed_case
    idx = routed_split_from_jax(_routed_arrays(jidx), n=RN, dim=RD, metric="l2",
                                cls=jidx.cls, cap=jidx.cap, device="cpu",
                                row_source=_rs_port(k1, centers))
    assert idx.base_dev is None and idx.sqnorms is None
    for kw in ({}, {"probes": 8, "tile": 32, "shared": 8, "fallback": 0.6}):
        want_i, want_d = jidx.search(queries, 10, batch_size=64, **kw)
        got_i, got_d = idx.search(queries, 10, batch_size=64, **kw)
        _ids_agree(got_i, want_i)
        assert idx.last_fallback == jidx.last_fallback
    assert recall_at_k(got_i, gt, 10) > 0.9


def test_routed_rowkeyed_build_matches_jax_with_its_draws(routed_case, monkeypatch):
    """The port's row-keyed build with JAX's draws injected (the training
    sample, the k-means init, the spatial order's first centre): recall
    within 0.01 of the JAX build's, and no base held."""
    k1, centers, queries, gt, jidx = routed_case
    monkeypatch.setattr(trs, "_draw_train_ids", lambda n, ts, seed: torch.from_numpy(
        np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (ts,), 0, n,
                                      dtype=jnp.int32)).astype(np.int64)))
    monkeypatch.setattr(tivf, "_draw_init_ids", lambda n, k, seed: torch.from_numpy(
        np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                     replace=False)).astype(np.int64)))
    monkeypatch.setattr(tpl, "_draw_first", lambda n, seed: int(
        jax.random.randint(jax.random.PRNGKey(seed), (), 0, n)))
    idx, got_gt = build_routed_split(RN, RD, row_source=_rs_port(k1, centers), queries=queries,
                                     **ROUTED)
    assert idx.base_dev is None and (idx.C, idx.cap) == (jidx.C, jidx.cap)
    assert recall_at_k(got_gt, gt, 10) >= MIN_GT_OVERLAP
    want_i, _ = jidx.search(queries, 10, batch_size=64)
    got_i, _ = idx.search(queries, 10, batch_size=64)
    assert abs(recall_at_k(got_i, gt, 10) - recall_at_k(np.asarray(want_i), gt, 10)) <= 0.01
    # the same build from the resident base gives the same tables
    base_idx = build_routed_split(RN, RD, base_dev=torch.from_numpy(np.asarray(
        regen.regen_rows(*_rs_port(k1, centers), torch.arange(RN)))), **ROUTED)
    np.testing.assert_array_equal(base_idx.gid.numpy(), idx.gid.numpy())
    np.testing.assert_array_equal(base_idx.comp.numpy(), idx.comp.numpy())


def test_routed_checkpoint_carries_the_row_source(tmp_path, routed_case):
    """A row-source checkpoint written by either package loads in the other
    with its source, and serves the same ids."""
    k1, centers, queries, _, jidx = routed_case
    path = str(tmp_path / "jax.npz")
    jc.save_routed_split(jidx, path)
    idx = load_routed_split(path, device="cpu")
    key, cents = idx.row_source
    np.testing.assert_array_equal(key.numpy(), _u32(k1))
    np.testing.assert_array_equal(cents.numpy(), np.asarray(centers))
    want_i, _ = jidx.search(queries, 10, batch_size=64)
    got_i, _ = idx.search(queries, 10, batch_size=64)
    _ids_agree(got_i, want_i)
    back = str(tmp_path / "port.npz")
    save_routed_split(idx, back)
    jback = jc.load_routed_split(back)
    np.testing.assert_array_equal(_u32(jback.row_source[0]), _u32(k1))
    assert np.asarray(jback.row_source[0]).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(jback.row_source[1]), np.asarray(centers))
    np.testing.assert_array_equal(jback.search(queries, 10, batch_size=64)[0], want_i)
    again = load_routed_split(back, device="cpu")
    np.testing.assert_array_equal(again.search(queries, 10, batch_size=64)[0], got_i)


def test_routed_index_needs_a_row_source_or_a_base(routed_case):
    _, _, queries, _, jidx = routed_case
    idx = routed_split_from_jax(_routed_arrays(jidx), n=RN, dim=RD, metric="l2",
                                cls=jidx.cls, cap=jidx.cap, device="cpu")
    with pytest.raises(ValueError, match="row_source or base_dev"):
        idx.search(queries, 10, batch_size=64)
    with pytest.raises(ValueError, match="row_source or base_dev"):
        build_routed_split(RN, RD, **ROUTED)
    assert isinstance(idx, RoutedSplitIndex)
