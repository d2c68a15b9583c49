"""The port's portable resampling (``ops/resampling.py``) against the JAX
package's, per key.

Positions are threefry draws the port reproduces bit for bit, so
``_positions`` must agree exactly. ``resample_indices`` must agree
exactly too: both search a cumulative sum of the same weights with the
same lower-bound rule, and the weights and positions here are continuous
random values, so an ulp of difference between the two cumulative sums
lands on a boundary with negligible probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.resampling import (
    _positions as j_positions,
    gather_particles as j_gather,
    resample_indices as j_resample,
)
from bayesssm_tpu_torch.ops.resampling import (
    _positions,
    gather_particles,
    metropolis_resample_indices,
    resample_indices,
)

torch.set_num_threads(1)

N = 64
KEYS = 4
METHODS = ("stratified", "systematic", "multinomial")


def _key_data(first=20):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + KEYS)])


def _weights(alive, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.5, size=(KEYS, N)).astype(np.float32)
    w[:, alive:] = 0.0
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("alive", [N, 41])
def test_positions_exact(method, alive):
    kd = _key_data()
    want = np.stack([np.asarray(j_positions(
        jax.random.wrap_key_data(jnp.asarray(w)), method, (), N,
        jnp.float32(alive), jnp.float32)) for w in kd])
    got = _positions(torch.as_tensor(kd.astype(np.int64)), method, N,
                     torch.full((KEYS,), float(alive)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("alive", [N, 41])
def test_resample_indices_exact(method, alive):
    kd = _key_data(40)
    w = _weights(alive, seed=alive)
    want = np.stack([np.asarray(j_resample(
        jax.random.wrap_key_data(jnp.asarray(k)), jnp.asarray(w[i]), method,
        num_alive=jnp.float32(alive))) for i, k in enumerate(kd)])
    got = resample_indices(torch.as_tensor(kd.astype(np.int64)),
                           torch.as_tensor(w), method, num_alive=alive)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < alive


def test_resample_indices_default_all_alive():
    kd = _key_data(60)
    w = _weights(N, seed=3)
    want = np.stack([np.asarray(j_resample(
        jax.random.wrap_key_data(jnp.asarray(k)), jnp.asarray(w[i])))
        for i, k in enumerate(kd)])
    got = resample_indices(torch.as_tensor(kd.astype(np.int64)),
                           torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [None, 3])
def test_gather_particles(d):
    rng = np.random.default_rng(5)
    shape = (KEYS, N) if d is None else (KEYS, N, d)
    p = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, N, size=(KEYS, N))
    want = np.stack([np.asarray(j_gather(jnp.asarray(p[i]),
                                         jnp.asarray(idx[i])))
                     for i in range(KEYS)])
    got = gather_particles(torch.as_tensor(p), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad,match", [
    (-1.0, "Weights must be non-negative"),
    (0.0, "Sum of weights must be greater than 0"),
])
def test_weight_validation_messages(bad, match):
    w = np.full((2, 8), bad, np.float32)
    words = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        j_resample(jax.random.key(0), jnp.asarray(w[0]))
    with pytest.raises(ValueError, match=match):
        resample_indices(words, torch.as_tensor(w), "stratified")
    # The engine's call skips the host-side check, as the JAX engine's
    # traced call does.
    resample_indices(words, torch.as_tensor(np.abs(w) + 1.0), "stratified",
                     validate=False)


def test_unknown_and_unported_methods():
    words = torch.zeros((1, 2), dtype=torch.int64)
    w = torch.full((1, 8), 0.125)
    with pytest.raises(ValueError, match="unknown resampling method"):
        resample_indices(words, w, "bogus")
    # "metropolis" dispatches to the Metropolis resampler, as in JAX
    # (``resample_indices`` :221-222).
    got = resample_indices(words, w, "metropolis")
    want = metropolis_resample_indices(words, w, num_alive=torch.full(
        (1,), 8.0))
    assert got.shape == (1, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
