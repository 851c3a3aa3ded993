"""The port's beam (shine_tpu_torch.ops.beam) against shine_tpu.ops.beam:
the same numpy inputs must give the same outputs bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.ops import beam as jb
from shine_tpu_torch.ops import beam as tb


def _random_candidates(rng, B, K, n_ids):
    """Candidates with repeated ids, -1 pads and many equal (and signed-zero)
    distances."""
    ids = rng.integers(-1, n_ids, size=(B, K)).astype(np.int32)
    d = (rng.integers(-3, 6, size=(B, K)) / 4.0).astype(np.float32)
    d[rng.random((B, K)) < 0.05] = -0.0
    return d, ids


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:  # bit for bit, -0.0 and +0.0 apart
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _same_beam(jbeam, tbeam):
    for f in ("dists", "ids", "expanded"):
        _same(getattr(jbeam, f), getattr(tbeam, f).numpy())


@pytest.mark.parametrize("ef,K,width", [
    (8, 16, 1), (8, 64, 4), (32, 16, 8), (32, 64, 4), (48, 128, 8),
])
def test_beam_ops_bit_for_bit(ef, K, width):
    rng = np.random.default_rng(ef * 1000 + K + width)
    B, n_ids = 16, 3 * ef
    jbeam, tbeam = jb.beam_init(B, ef), tb.beam_init(B, ef)
    _same_beam(jbeam, tbeam)
    for _ in range(4):
        d, ids = _random_candidates(rng, B, K, n_ids)
        jbeam = jb.beam_merge(jbeam, jnp.asarray(d), jnp.asarray(ids))
        tbeam = tb.beam_merge(tbeam, torch.from_numpy(d), torch.from_numpy(ids))
        _same_beam(jbeam, tbeam)

        js, jf, ja = jb.beam_frontier_multi(jbeam, width)
        ts, tf, ta = tb.beam_frontier_multi(tbeam, width)
        _same(js, ts.numpy().astype(np.int32))
        _same(jf, tf.numpy())
        _same(ja, ta.numpy())

        j1 = jb.beam_frontier(jbeam)
        t1 = tb.beam_frontier(tbeam)
        for x, y in zip(j1, t1):
            _same(x, y.numpy().astype(np.asarray(x).dtype))

        jbeam = jb.beam_mark_expanded(jbeam, js, ja)
        tbeam = tb.beam_mark_expanded(tbeam, ts, ta)
        _same_beam(jbeam, tbeam)
    # single-slot form of beam_mark_expanded
    jbeam = jb.beam_mark_expanded(jbeam, j1[0], j1[2])
    tbeam = tb.beam_mark_expanded(tbeam, t1[0], t1[2])
    _same_beam(jbeam, tbeam)


def test_beam_merge_keeps_expanded_copy_of_duplicates():
    """A re-discovered id keeps its beam entry's expanded flag."""
    beam = tb.beam_merge(
        tb.beam_init(1, 4), torch.tensor([[1.0, 2.0]]),
        torch.tensor([[5, 7]], dtype=torch.int32),
    )
    beam = tb.beam_mark_expanded(
        beam, torch.tensor([0]), torch.tensor([True]))
    beam = tb.beam_merge(
        beam, torch.tensor([[1.0, 0.5, 0.5]]),
        torch.tensor([[5, 9, 9]], dtype=torch.int32),
    )
    assert beam.ids.tolist() == [[9, 5, 7, -1]]
    assert beam.expanded.tolist() == [[False, True, False, True]]
    assert beam.dists[0, 3] == float("inf")


def test_dist_id_key_orders_like_dist_then_id():
    d = torch.tensor([-2.0, -0.0, 0.0, 1.5, float("inf"), 1.5, -2.0, float("inf")])
    ids = torch.tensor([3, 4, 2, 9, -1, 1, 0, 6], dtype=torch.int32)
    order = torch.argsort(tb.dist_id_key(d, ids)).tolist()
    key_i = [i if i >= 0 else 2**31 - 1 for i in ids.tolist()]
    want = sorted(range(8), key=lambda j: (d[j].item(), key_i[j]))
    assert order == want
