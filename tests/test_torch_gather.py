"""gather_score (shine_tpu_torch.ops.gather_score) against the JAX path it
replaces: the scoring in shine_tpu.models.hnsw._dist_ext and the Pallas row
gather shine_tpu.ops.pallas_gather (in interpret mode, as tests/test_pallas.py
runs it). On the CPU gather_score runs its plain twin; the CUDA kernel itself
is checked in tests/test_torch_kernel.py, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.models import hnsw as jh
from shine_tpu_torch.graph.soa import GraphSoA as PortGraph
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref

# the two frameworks sum the dot products in different orders (f32 ulps)
RTOL, ATOL = 1e-5, 1e-4


def _graph(rng, n, d) -> GraphSoA:
    """A graph with random rows and no edges: only its rows are scored."""
    return GraphSoA(
        params=HNSWParams(M=4),
        vectors=rng.normal(size=(n, d)).astype(np.float32),
        levels=np.zeros(n, np.int32),
        neighbors0=np.full((n, 8), -1, np.int32),
        upper_row=np.full(n, -1, np.int32),
        upper_neighbors=np.zeros((0, 1, 4), np.int32),
        entry_point=0,
        top_level=0,
    )


def _inputs(rng, n, B, K, d, l2):
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    q_ext = -2.0 * q if l2 else -q
    bias = (q * q).sum(1) if l2 else np.ones(B, np.float32)
    return q_ext.astype(np.float32), bias.astype(np.float32), ids


def _port(tg, q_ext, bias, ids, l2):
    return gather_score(
        tg.vectors_ext, torch.from_numpy(q_ext), torch.from_numpy(bias),
        torch.from_numpy(ids), row_scl=tg.row_scl,
        row_nrm=tg.row_nrm if l2 else None, l2=l2,
    ).numpy()


@pytest.mark.parametrize("d", [8, 24, 32])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_gather_score_matches_dist_ext(rows, metric, d):
    rng = np.random.default_rng(d)
    n, B, K, l2 = 500, 12, 40, metric == "l2"
    graph = _graph(rng, n, d)
    jg, _ = jh.device_graph(graph, rows=rows)
    tg = th.device_graph(PortGraph.from_fields(graph), rows=rows, device="cpu")
    q_ext, bias, ids = _inputs(rng, n, B, K, d, l2)
    want = np.asarray(jh._dist_ext(
        jg, jnp.asarray(q_ext), jnp.asarray(bias), jnp.asarray(ids),
        use_pallas=False, l2=l2,
    ))
    got = _port(tg, q_ext, bias, ids, l2)
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_gather_score_matches_pallas_gather(rows):
    """Score the rows that the Pallas gather (K1) fetches, with
    _dist_ext's formula in numpy, and hold the port against it."""
    from shine_tpu.ops.pallas_gather import gather_rows_pallas

    rng = np.random.default_rng(7)
    n, B, K, d = 600, 8, 48, 32
    graph = _graph(rng, n, d)
    jg, _ = jh.device_graph(graph, rows=rows)
    tg = th.device_graph(PortGraph.from_fields(graph), rows=rows, device="cpu")
    for l2 in (True, False):
        q_ext, bias, ids = _inputs(rng, n, B, K, d, l2)
        safe = np.maximum(ids, 0)
        ve = gather_rows_pallas(
            jg.vectors_ext, jnp.asarray(safe.reshape(-1)), blk=128,
            interpret=True,
        )
        ve = np.asarray(ve.astype(jnp.float32)).reshape(B, K, d)
        dots = np.einsum("bd,bkd->bk", q_ext, ve)
        if rows == "int8":
            dots = dots * np.asarray(jg.row_scl)[safe]
            if l2:
                dots = dots + np.asarray(jg.row_nrm)[safe]
        elif l2:
            dots = dots + (ve * ve).sum(-1)
        want = np.where(ids >= 0, bias[:, None] + dots, np.inf)
        got = _port(tg, q_ext, bias, ids, l2)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gather_score_cpu_runs_twin_and_counts_no_launch():
    rng = np.random.default_rng(3)
    tg = th.device_graph(PortGraph.from_fields(_graph(rng, 100, 16)),
                         rows="f32", device="cpu")
    q_ext, bias, ids = _inputs(rng, 100, 4, 10, 16, True)
    before = gather_score.launches
    got = _port(tg, q_ext, bias, ids, True)
    want = gather_score_ref(
        tg.vectors_ext, torch.from_numpy(q_ext), torch.from_numpy(bias),
        torch.from_numpy(ids),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert gather_score.launches == before


@pytest.mark.parametrize("bad", [
    "meta_device", "f64_rows", "i64_ids", "q_width", "strided_ids",
    "int8_no_scale", "f32_with_scale",
])
def test_gather_score_rejects(bad):
    v = torch.zeros(10, 8)
    q, b = torch.zeros(2, 8), torch.zeros(2)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    kw = {}
    if bad == "meta_device":
        v = v.to("meta")
    elif bad == "f64_rows":
        v = v.double()
    elif bad == "i64_ids":
        ids = ids.long()
    elif bad == "q_width":
        q = torch.zeros(2, 9)
    elif bad == "strided_ids":
        ids = torch.zeros(3, 2, dtype=torch.int32).T
    elif bad == "int8_no_scale":
        v = v.to(torch.int8)
    elif bad == "f32_with_scale":
        kw = {"row_scl": torch.ones(10)}
    with pytest.raises((TypeError, ValueError)):
        gather_score(v, q, b, ids, **kw)
