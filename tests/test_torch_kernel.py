"""The CUDA kernel gather_score against its plain twin, on a card.

Every test here needs a CUDA card and nvcc and skips without them. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph.soa import build_graph
from shine_tpu.io import synthetic_dataset
from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.models.hnsw import quantize_rows
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref

pytestmark = pytest.mark.cuda

# distances here are O(1e2) (L2) and the kernel sums in another order
RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(rng, n, B, K, d, rows, l2, dev):
    tables = {k: v.to(dev) for k, v in quantize_rows(
        rng.normal(size=(n, d)).astype(np.float32), rows).items()}
    vectors = tables.pop("vectors_ext")
    if not l2:
        tables.pop("row_nrm", None)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    q_ext = (-2.0 * q if l2 else -q).astype(np.float32)
    bias = ((q * q).sum(1) if l2 else np.ones(B)).astype(np.float32)
    args = [vectors] + [torch.from_numpy(a).to(dev) for a in (q_ext, bias, ids)]
    return args, dict(tables, l2=l2)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 128, 960])
@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_kernel_matches_twin(card, rows, d):
    rng = np.random.default_rng(d)
    for l2 in (True, False):
        args, kw = _case(rng, 3000, 16, 96, d, rows, l2, card)
        before = gather_score.launches
        got = gather_score(*args, **kw)
        torch.cuda.synchronize()
        assert gather_score.launches == before + 1
        want = gather_score_ref(*args, **kw)
        assert torch.equal(torch.isinf(got), args[3] < 0)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_marks_out_of_range_ids_nan(card):
    args, kw = _case(np.random.default_rng(1), 100, 2, 8, 32, "f32", True, card)
    args[3][0, 0] = 100
    got = gather_score(*args, **kw)
    assert torch.isnan(got[0, 0]) and torch.isfinite(got[0, 1:][args[3][0, 1:] >= 0]).all()


def test_kernel_rejects_cpu_mixed_inputs(card):
    args, kw = _case(np.random.default_rng(2), 100, 2, 8, 32, "f32", True, card)
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        gather_score(*args, **kw)


def test_search_on_card_matches_cpu(card):
    ds = synthetic_dataset(n=4000, dim=32, num_queries=128, seed=5,
                           compute_gt=False)
    graph = build_graph(ds.base, HNSWParams(M=8, ef_construction=64), threads=1)
    sp = SearchParams(k=10, ef=48, frontier=4)
    for rows in ("f32", "bf16", "int8"):
        a, da = HNSWIndex(graph, rows=rows).search(ds.queries, sp, batch_size=64)
        before = gather_score.launches
        b_idx = HNSWIndex(graph, rows=rows, device=card)
        b, db = b_idx.search(ds.queries, sp, batch_size=64)
        assert gather_score.launches - before == b_idx.last_steps > 0
        assert (a == b).mean() >= 0.99
        same = a == b
        np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)
