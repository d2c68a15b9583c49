"""The plain Gillespie day-step (K4, ``ops/gillespie.py``) against the JAX
kernel under the Pallas interpreter, per key.

Each JAX reference is an UN-vmapped ``interpret=True`` call: one chain per
program, whose software stream the port reproduces. The event arithmetic
is the same sequence of float32 operations, so S and I must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.gillespie_pallas import gillespie_step_pallas as j_step
from bayesssm_tpu_torch.ops.gillespie import (
    gillespie_step,
    gillespie_step_reference,
)

torch.set_num_threads(1)

N = 128
N_TOTAL = 500


@functools.lru_cache(maxsize=None)
def _j(t_end, unroll):
    return jax.jit(lambda kd, st, lam, gam: j_step(
        jax.random.wrap_key_data(kd), st, lam, gam, N_TOTAL, t_end=t_end,
        unroll=unroll, interpret=True))


def _states(c, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(250, 431, size=(c, N))
    i = np.minimum(rng.integers(0, 120, size=(c, N)), N_TOTAL - s)
    i[0] = 0            # a chain with no infectious lane: no event at all
    i[1, :7] = 0        # and lanes with I = 0 beside live ones
    return np.stack([s, i], axis=-1).astype(np.float32)


@pytest.mark.parametrize("t_end,unroll", [(1.0, 8), (0.5, 4)])
def test_matches_jax_per_key(t_end, unroll):
    c = 4
    state = _states(c, 11)
    rng = np.random.default_rng(12)
    lam = rng.uniform(0.3, 0.9, c).astype(np.float32)
    gam = rng.uniform(0.1, 0.35, c).astype(np.float32)
    kd = np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                   for k in range(30, 30 + c)])
    fn = _j(t_end, unroll)
    want = np.stack([np.asarray(fn(jnp.asarray(kd[k]), state[k], lam[k],
                                   gam[k])) for k in range(c)])
    got = gillespie_step(torch.as_tensor(kd.astype(np.int64)),
                         torch.as_tensor(state), torch.as_tensor(lam),
                         torch.as_tensor(gam), N_TOTAL, t_end, unroll)
    assert got.shape == (c, N, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Something happened, and nothing happened where I = 0.
    assert not np.array_equal(want[2:], state[2:])
    np.testing.assert_array_equal(want[0], state[0])
    np.testing.assert_array_equal(want[1, :7], state[1, :7])


def test_population_bounds_and_scalar_rates():
    state = torch.as_tensor(_states(3, 5))
    words = torch.tensor([[0, 1], [5, 6], [2**32 - 1, 3]], dtype=torch.int64)
    out = gillespie_step(words, state, 0.6, 0.2, N_TOTAL)
    s, i = out[..., 0], out[..., 1]
    # S only falls; S + I only falls (removals); nothing goes negative.
    assert (s <= state[..., 0]).all() and (i >= 0).all()
    assert (out.sum(-1) <= state.sum(-1)).all()
    # Each chain depends on its own key and state only.
    one = gillespie_step(words[1:2], state[1:2], 0.6, 0.2, N_TOTAL)
    assert torch.equal(one[0], out[1])
    assert torch.equal(out, gillespie_step_reference(words, state, 0.6, 0.2,
                                                     N_TOTAL))


def test_validation():
    words = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"state must be \[C, N, 2\]"):
        gillespie_step(words, torch.zeros((2, N)), 0.5, 0.2, N_TOTAL)
    with pytest.raises(ValueError, match="key words must be"):
        gillespie_step(words[:1], torch.zeros((2, N, 2)), 0.5, 0.2, N_TOTAL)
