"""The port's HNSW search (shine_tpu_torch.models.hnsw) against
shine_tpu.models.hnsw on one graph, built once per module with one thread
(the multithreaded native build is not deterministic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph.soa import build_graph
from shine_tpu.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu.models import hnsw as jh
from shine_tpu_torch import HNSWIndex, device_graph_from_jax
from shine_tpu_torch.graph.soa import GraphSoA as PortGraph
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.ops.distance import exact_knn
from shine_tpu_torch.ops.beam_step import beam_step
from shine_tpu_torch.ops.gather_score import gather_score

# ids may differ where f32 sums in another order flip a near-tie
MIN_OVERLAP = 0.99
# distances of matching ids: an L2 distance is |q|^2 - 2 q.v + |v|^2 with
# terms up to ~1e3 on these sets, and the two frameworks sum them in other
# orders, so they differ by a few ulp of those terms (ulp(512) = 6.1e-5)
RTOL, ATOL = 1e-5, 5e-4
COUNTER_RTOL = 0.01  # hops and exact-distance counters


@pytest.fixture(scope="module")
def l2_case():
    ds = synthetic_dataset(n=4000, dim=16, num_queries=96, seed=11)
    return ds, build_graph(ds.base, HNSWParams(M=8, ef_construction=64),
                           threads=1)


@pytest.fixture(scope="module")
def ip_case():
    ds = synthetic_dataset(n=3000, dim=24, num_queries=64, seed=3, metric="ip")
    params = HNSWParams(M=8, ef_construction=64, metric="ip")
    return ds, build_graph(ds.base, params, threads=1)


def _arrays(jg):
    return {k: None if v is None else np.asarray(v)
            for k, v in jg._asdict().items()}


@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_tables_from_jax_match_port_upload(l2_case, rows):
    _, graph = l2_case
    jg, top = jh.device_graph(graph, rows=rows)
    assert jg.neighbors0.shape[1] == 128  # packed by the JAX package
    conv = device_graph_from_jax(_arrays(jg), top_level=top,
                                 nbr_width=graph.neighbors0.shape[1],
                                 device="cpu")
    own = th.device_graph(PortGraph.from_fields(graph), rows=rows,
                          device="cpu")
    assert (conv.entry_point, conv.top_level) == (own.entry_point, own.top_level)
    for f in ("vectors_ext", "neighbors0", "upper_row", "upper_neighbors",
              "upper_ids", "upper_vecs_ext", "row_scl", "row_nrm"):
        a, b = getattr(conv, f), getattr(own, f)
        if a is None or b is None:
            assert a is None and b is None and rows != "int8", f
            continue
        assert a.dtype == b.dtype, f
        if a.dtype == torch.bfloat16:  # compare the bits
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("width", [5, 0])
def test_convert_rejects_list_width_that_does_not_divide(l2_case, width):
    _, graph = l2_case
    jg, top = jh.device_graph(graph)
    with pytest.raises(ValueError, match="nbr_width"):
        device_graph_from_jax(_arrays(jg), top_level=top, nbr_width=width,
                              device="cpu")


def _search_both(graph, queries, sp, rows, uchunk=None):
    """(JAX ids, dists, hops, dists-count), (port ...) on one graph."""
    old_j, old_t = jh.ENTRY_UCHUNK, th.ENTRY_UCHUNK
    try:
        if uchunk is not None:
            jh.ENTRY_UCHUNK = th.ENTRY_UCHUNK = uchunk
        # the constant is not part of the jit cache key: force a retrace
        jh.batched_search.clear_cache()
        out = []
        for idx in (jh.HNSWIndex(graph, rows=rows),
                    HNSWIndex(PortGraph.from_fields(graph), rows=rows,
                              device="cpu")):
            ids, dd = idx.search(queries, sp, batch_size=64)
            out.append((ids, dd, idx.last_hops, idx.last_dists))
    finally:
        jh.ENTRY_UCHUNK, th.ENTRY_UCHUNK = old_j, old_t
        jh.batched_search.clear_cache()
    return out


def _assert_close_results(jax_out, port_out):
    (a_ids, a_d, a_h, a_c), (b_ids, b_d, b_h, b_c) = jax_out, port_out
    overlap = recall_at_k(b_ids, a_ids, a_ids.shape[1])
    assert overlap >= MIN_OVERLAP, overlap
    qi, ai, bi = np.nonzero(a_ids[:, :, None] == b_ids[:, None, :])
    np.testing.assert_allclose(b_d[qi, bi], a_d[qi, ai], rtol=RTOL, atol=ATOL)
    assert abs(b_h - a_h) <= COUNTER_RTOL * a_h, (a_h, b_h)
    assert abs(b_c - a_c) <= COUNTER_RTOL * a_c, (a_c, b_c)


@pytest.mark.parametrize("entry,term,frontier,metric,rows", [
    ("dense", "ef", 4, "l2", "f32"),
    ("dense", "k", 4, "l2", "f32"),
    ("dense", "ef", 1, "l2", "f32"),
    ("dense", "ef", 4, "l2", "bf16"),
    ("dense", "ef", 4, "l2", "int8"),
    ("descent", "ef", 4, "l2", "f32"),
    ("descent", "k", 1, "l2", "bf16"),
    ("dense", "ef", 4, "ip", "f32"),
    ("dense", "k", 1, "ip", "int8"),
    ("descent", "ef", 4, "ip", "int8"),
    ("descent", "ef", 1, "ip", "bf16"),
])
def test_search_matches_jax(l2_case, ip_case, entry, term, frontier, metric,
                            rows):
    ds, graph = l2_case if metric == "l2" else ip_case
    sp = SearchParams(k=10, ef=48, frontier=frontier, entry_mode=entry,
                      term=term)
    jax_out, port_out = _search_both(graph, ds.queries[:64], sp, rows)
    _assert_close_results(jax_out, port_out)


@pytest.mark.parametrize("chunking", ["even", "clamped_tail"])
def test_chunked_dense_entry_matches_jax(l2_case, chunking):
    """The chunked dense entry (forced by a small ENTRY_UCHUNK) against
    JAX, and against the port's one-shot entry. 'clamped_tail' makes the
    last window overlap the one before, which the idx >= lo mask guards."""
    ds, graph = l2_case
    U = int((graph.levels > 0).sum())
    if chunking == "even":
        uchunk, sp = 64, SearchParams(k=10, ef=48)
    else:
        uchunk = U // 2 + 3
        sp = SearchParams(k=10, ef=48, entry_seeds=min(U, 32))
    assert U > uchunk
    queries = ds.queries[:64]
    jax_out, port_out = _search_both(graph, queries, sp, "f32", uchunk=uchunk)
    _assert_close_results(jax_out, port_out)
    one_shot = HNSWIndex(PortGraph.from_fields(graph), device="cpu").search(
        queries, sp, batch_size=64)
    np.testing.assert_array_equal(port_out[0], one_shot[0])
    np.testing.assert_allclose(port_out[1], one_shot[1], rtol=1e-4, atol=1e-3)


def test_index_tail_padding_and_recall(l2_case):
    ds, graph = l2_case
    idx = HNSWIndex(PortGraph.from_fields(graph), device="cpu")
    sp = SearchParams(k=10, ef=64)
    a, _ = idx.search(ds.queries[:70], sp, batch_size=64)
    b, _ = idx.search(ds.queries[:70], sp, batch_size=128)
    np.testing.assert_array_equal(a, b)
    ids, dists = idx.search(ds.queries, sp, batch_size=64)
    assert recall_at_k(ids, ds.ground_truth, 10) >= 0.95
    assert np.all(np.diff(dists, axis=1) >= 0)
    assert idx.last_hops > 0 and idx.last_steps > 0
    assert 0 < idx.last_dists


def test_cpu_search_launches_no_kernel(l2_case):
    ds, graph = l2_case
    before = gather_score.launches, beam_step.launches
    HNSWIndex(PortGraph.from_fields(graph), device="cpu").search(
        ds.queries[:8], SearchParams(k=5, ef=16),
                            batch_size=8)
    assert (gather_score.launches, beam_step.launches) == before


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_knn_matches_numpy_brute_force(l2_case, ip_case, metric):
    ds, _ = l2_case if metric == "l2" else ip_case
    want_i, want_d = brute_force_knn(ds.base, ds.queries, 10, metric=metric)
    got_i, got_d = exact_knn(torch.from_numpy(ds.base),
                             torch.from_numpy(ds.queries), 10, metric=metric,
                             chunk=1000)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m", [1, 3, 7])
def test_top_m_ties_like_lax_top_k(m):
    d = np.random.default_rng(m).integers(0, 6, size=(8, 40)).astype(np.float32)
    neg, sel = jax.lax.top_k(-jnp.asarray(d), m)
    vals, pos = th._top_m(torch.from_numpy(d.copy()), m)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
