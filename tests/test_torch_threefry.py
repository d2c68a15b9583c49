"""The port's threefry keys and draws against ``jax.random``, per key.

``split``, ``fold_in``, ``random_bits`` and ``uniform`` are integer or
bit-exact operations and must agree exactly. ``normal`` goes through
``erfinv``, whose float32 polynomial the port evaluates with PyTorch's
``log1p`` and without fused multiply-adds: it agrees to 1e-6 (a few ulps
of values up to about 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.ops import threefry

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2**31 + 7)


def _key_data(seeds=SEEDS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(s)))
                     for s in seeds])


def _per_key(fn, kd):
    return np.stack([np.asarray(fn(jax.random.wrap_key_data(jnp.asarray(w))))
                     for w in kd])


def test_jax_uses_partitionable_threefry():
    # The port follows the partitionable split and random_bits; a change
    # of the JAX default has to show up here, not as a silent mismatch.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 3, 2**32 + 5, -1])
def test_key(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(threefry.key(seed).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (2,), (10, 5)])
def test_split(shape):
    kd = _key_data()
    want = _per_key(
        lambda k: jax.random.key_data(jax.random.split(k, shape)), kd)
    got = threefry.split(threefry.as_key_words(kd), shape)
    assert got.shape == (len(kd), *shape, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_split_default_is_two():
    kd = _key_data()
    want = _per_key(lambda k: jax.random.key_data(jax.random.split(k)), kd)
    np.testing.assert_array_equal(
        threefry.split(threefry.as_key_words(kd)).numpy(),
        want.astype(np.int64))


@pytest.mark.parametrize("data", [0, 1, 7, 2**32 - 1])
def test_fold_in(data):
    kd = _key_data()
    want = _per_key(
        lambda k: jax.random.key_data(jax.random.fold_in(k, data)), kd)
    np.testing.assert_array_equal(
        threefry.fold_in(threefry.as_key_words(kd), data).numpy(),
        want.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_random_bits(shape):
    kd = _key_data()
    want = _per_key(lambda k: jax.random.bits(k, shape), kd)
    np.testing.assert_array_equal(
        threefry.random_bits(threefry.as_key_words(kd), shape).numpy(),
        want.astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0.0, 1.0), ((257,), 0.0, 1.0), ((4, 9), -2.0, 3.5),
])
def test_uniform_exact(shape, lo, hi):
    kd = _key_data()
    want = _per_key(
        lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi), kd)
    got = threefry.uniform(threefry.as_key_words(kd), shape, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [
    ((257,), 0, 1), ((257,), -2, 3), ((64,), 0, 7), ((5, 9), 0, 2**31 - 1),
    ((300,), -1000, 17), ((12,), 5, 5), ((12,), 9, -4),
    ((33,), -2**31, 2**31 - 1),
])
def test_randint_exact(shape, lo, hi):
    """Spans 1, 5, 7, 2**31 - 1 and 2**32 - 1, negative minval and
    ``maxval <= minval``: the int32 results bit for bit."""
    kd = _key_data()
    want = _per_key(lambda k: jax.random.randint(k, shape, lo, hi), kd)
    got = threefry.randint(threefry.as_key_words(kd), shape, lo, hi)
    assert got.dtype == torch.int32 and got.shape == (len(kd), *shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal():
    kd = _key_data(range(12))
    want = _per_key(lambda k: jax.random.normal(k, (500,)), kd)
    got = threefry.normal(threefry.as_key_words(kd), (500,))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float((got.numpy() == want).mean()) > 0.9


def test_key_words_from_numpy_and_errors():
    kd = _key_data()
    words = threefry.as_key_words(kd)
    assert words.dtype == torch.int64 and (words >= 0).all()
    np.testing.assert_array_equal(
        threefry.as_key_words(torch.as_tensor(kd.astype(np.int64))).numpy(),
        words.numpy())
    with pytest.raises(ValueError, match="trailing axis of 2"):
        threefry.as_key_words(np.zeros((3, 4), np.uint32))
