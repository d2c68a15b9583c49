"""The port's threefry keys and draws against ``jax.random``, per key.

``split``, ``fold_in``, ``random_bits`` and ``uniform`` are integer or
bit-exact operations and must agree exactly. ``normal`` goes through
``erfinv``, whose float32 polynomial the port evaluates with PyTorch's
``log1p`` and without fused multiply-adds: it agrees to 1e-6 (a few ulps
of values up to about 5). ``binomial`` computes ``ceil(log(u) /
log1p(-q))`` and BTRS's bound with float32 logs, and XLA's CPU ``log`` is
its own polynomial, so a draw could land one integer off; at least 99% of
each key's draws must match (all 256,000 matched in a run of 16 keys x
4000 draws on each branch), and the moments must be Binomial(n, p)'s.
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


def _binomial_jax(kd, count, prob):
    f = jax.jit(lambda w, n, q: jax.random.binomial(
        jax.random.wrap_key_data(w), n, q))
    return np.stack([np.asarray(f(jnp.asarray(w), jnp.asarray(count[i]),
                                  jnp.asarray(prob[i])))
                     for i, w in enumerate(kd)])


BINOMIAL_CASES = {
    # count * q <= 10: inversion; p above one half draws count - k.
    "inversion": (0, 400, 0.0, 0.025),
    "inversion_p_above_half": (0, 400, 0.975, 1.0),
    # count * q > 10: BTRS (transformed rejection).
    "btrs": (50, 5000, 0.05, 0.5),
    "btrs_p_above_half": (50, 5000, 0.5, 0.95),
    "both": (0, 600, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(BINOMIAL_CASES))
def test_binomial_matches_jax_per_key(case):
    lo, hi, p_lo, p_hi = BINOMIAL_CASES[case]
    rng = np.random.default_rng(len(case))
    kd = _key_data(range(5))
    count = rng.integers(lo, hi, (5, 500)).astype(np.float32)
    prob = rng.uniform(p_lo, p_hi, (5, 500)).astype(np.float32)
    if case == "both":
        # NaN and negative counts, NaN, negative and > 1 probabilities, an
        # infinite count, p at 0 and 1.
        count[:, :4] = np.nan
        count[:, 4:8] = -3.0
        count[:, 8] = np.inf
        prob[:, 9:12] = np.nan
        prob[:, 12:14] = -0.2
        prob[:, 14:16] = 1.3
        prob[:, 16], prob[:, 17] = 0.0, 1.0
    want = _binomial_jax(kd, count, prob)
    got = threefry.binomial(threefry.as_key_words(kd), torch.as_tensor(count),
                            torch.as_tensor(prob))
    assert got.dtype == torch.float32 and got.shape == count.shape
    got = got.numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    share = same.mean(axis=1)
    assert (share >= 0.99).all(), share
    if case == "both":
        assert np.isnan(got[:, :8]).all() and np.isnan(got[:, 9:16]).all()
        assert np.isinf(got[:, 8]).all()
        assert (got[:, 16] == 0).all()
        np.testing.assert_array_equal(got[:, 17], count[:, 17])


@pytest.mark.parametrize("n,p", [(30.0, 0.1), (40.0, 0.85), (400.0, 0.3),
                                 (2000.0, 0.6)])
def test_binomial_moments(n, p):
    """Mean and variance of 64 keys x 2000 draws within five standard
    errors of Binomial(n, p)'s, on both algorithms and both sides of one
    half."""
    kd = threefry.split(threefry.key(7)[None], 64)[0]
    draws = threefry.binomial(kd, torch.full((64, 2000), n),
                              torch.full((64, 2000), p)).double().numpy()
    assert (draws == np.floor(draws)).all()
    assert ((draws >= 0) & (draws <= n)).all()
    m = draws.size
    mean, var = n * p, n * p * (1 - p)
    assert abs(draws.mean() - mean) < 5 * np.sqrt(var / m)
    # The sample variance's standard error, to first order.
    assert abs(draws.var() - var) < 5 * var * np.sqrt(2.0 / m) + 1e-9


def test_binomial_loops_shared_across_calls():
    """A view of one ``LoopKeys`` chain over many rows draws what each
    row's own keys draw (the tau-leaping day shares its splits so)."""
    kd = threefry.split(threefry.key(3)[None], 6)[0]            # [6, 2]
    count = torch.tensor([[5.0, 300.0, 40.0]]).expand(2, 3)
    prob = torch.tensor([[0.3, 0.2, 0.9]]).expand(2, 3)
    loops = (threefry.LoopKeys(kd, 2, 1), threefry.LoopKeys(kd, 3, 0))
    for rows in ([0, 1], [4, 2]):
        row_map = torch.tensor(rows)
        shared = threefry.binomial(
            kd[row_map], count, prob,
            loops=tuple(loop.rows(row_map) for loop in loops))
        alone = threefry.binomial(kd[row_map], count, prob)
        assert torch.equal(shared, alone)
