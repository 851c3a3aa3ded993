"""The seeded draws of the port against ``jax.random`` on the CPU, bit for
bit: ``ops/threefry.py``'s ``permutation`` and ``choice`` (without
replacement) at sizes of 0, 1, 2 and 3 sort rounds, and the draws of every
seeded build (the IVF device build's training sample and initial centres,
the routed build's training ids, the farthest-point init's first centre,
``FastFlatIndex.from_device``'s shuffle, in ``tests/test_torch_flat.py``)
with the JAX package's from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu_torch.models import ivf as tivf
from shine_tpu_torch.models import routed_split as trs
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.parallel import placement as tpl

# n = 1: no round; 2, 1000: one; 1626, 100,000: two; 2,700,000: three (one
# seed only: JAX's draw alone takes seconds there on the CPU)
CASES = [(n, seed) for n in (1, 2, 1000, 1626, 100_000) for seed in (0, 1234)]
CASES.append((2_700_000, 0))


@pytest.mark.parametrize("n,seed", CASES)
def test_permutation_and_choice_match_jax(n, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.permutation(key, n))
    got = tf.permutation(tf.prng_key(seed), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    k = max(1, n // 7)
    # JAX's choice without replacement is its permutation's prefix; it is
    # drawn again below the three-round size
    want_k = (want[:k] if n > 1_000_000
              else np.asarray(jax.random.choice(key, n, (k,), replace=False)))
    np.testing.assert_array_equal(tf.choice(tf.prng_key(seed), n, k).numpy(), want_k)


def test_shuffle_rounds():
    assert [tf._shuffle_rounds(n) for n in (1, 2, 1625, 1626, 2_642_245, 2_642_246)] \
        == [0, 1, 1, 2, 2, 3]


def test_choice_refuses_more_than_n():
    with pytest.raises(ValueError):
        tf.choice(tf.prng_key(0), 5, 6)


@pytest.mark.parametrize("n,ts,seed", [(50_000, 16_384, 1234), (200_000, 65_536, 7)])
def test_ivf_device_build_draws_are_jax(n, ts, seed):
    """``build_ivf_layout_device`` draws its sample with
    ``choice(PRNGKey(seed), n, (ts,))`` and ``_lloyd_chunked`` its initial
    centres from the same key over the sample."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        tivf._draw_train_ids(n, ts, seed).numpy(),
        np.asarray(jax.random.choice(key, n, (ts,), replace=False)))
    np.testing.assert_array_equal(
        tivf._draw_init_ids(ts, 64, seed).numpy(),
        np.asarray(jax.random.choice(key, ts, (64,), replace=False)))


@pytest.mark.parametrize("n,ts,seed", [(1_000_000, 8192, 1234), (100_663_296, 65_536, 17)])
def test_routed_and_placement_draws_are_jax(n, ts, seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        trs._draw_train_ids(n, ts, seed).numpy(),
        np.asarray(jax.random.randint(key, (ts,), 0, n, dtype=jnp.int32)))
    assert tpl._draw_first(n, seed) == int(jax.random.randint(key, (), 0, n))
