"""The port's native host search (``graph/soa.py:host_search``) against the
JAX package's on one graph, bit for bit, ids and distances; its recall, and
the batched search's agreement with it, as ``tests/test_search.py`` holds
the JAX package's; ``estimate_index_bytes`` against the JAX function."""

import dataclasses

import numpy as np
import pytest

from shine_tpu.config import HNSWParams as JParams
from shine_tpu.graph import soa as jsoa
from shine_tpu_torch import HNSWIndex, HNSWParams, SearchParams
from shine_tpu_torch.graph import build_graph, host_search
from shine_tpu_torch.graph.soa import estimate_index_bytes
from shine_tpu_torch.io import recall_at_k, synthetic_dataset


def _jax_graph(g):
    p = g.params
    fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    fields["params"] = JParams(M=p.M, ef_construction=p.ef_construction,
                               metric=p.metric, seed=p.seed)
    return jsoa.GraphSoA(**fields)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_host_search_bit_for_bit_with_jax(metric):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((3000, 24)).astype(np.float32)
    queries = rng.standard_normal((64, 24)).astype(np.float32)
    g = build_graph(base, HNSWParams(M=8, ef_construction=64, metric=metric), threads=1)
    jg = _jax_graph(g)
    for k, ef in ((10, 32), (5, 96)):
        ids, dists = host_search(g, queries, k, ef, threads=3)
        j_ids, j_dists = jsoa.host_search(jg, queries, k, ef, threads=1)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(dists.view(np.uint32), j_dists.view(np.uint32))
    # more results than the beam holds: -1 and +inf past it
    ids, dists = host_search(g, queries[:4], 12, 8)
    assert (ids[:, 8:] == -1).all() and np.isinf(dists[:, 8:]).all()


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=5000, dim=32, num_queries=100, seed=7)


@pytest.fixture(scope="module")
def graph(ds):
    g = build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=8)
    g.validate()
    return g


def test_host_search_recall(ds, graph):
    ids, dists = host_search(graph, ds.queries, 10, 64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.95, r
    assert np.all(np.diff(dists, axis=1) >= 0)


def test_batched_matches_host_closely(ds, graph):
    """At ef >> k the batched search (the beam truncated to the top-ef set)
    agrees with the host oracle almost everywhere."""
    idx = HNSWIndex(graph, device="cpu")
    h_ids, _ = host_search(graph, ds.queries, 10, 128)
    t_ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=128), batch_size=128)
    overlap = recall_at_k(t_ids, h_ids, 10)
    assert overlap > 0.97, overlap


@pytest.mark.parametrize("n", [1, 1000, 100_663_296])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("M", [4, 16, 32])
def test_estimate_index_bytes_matches_jax(n, d, M):
    assert estimate_index_bytes(n, d, HNSWParams(M=M)) == \
        jsoa.estimate_index_bytes(n, d, JParams(M=M))
