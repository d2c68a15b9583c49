"""The port's counter stream (bayesssm_tpu_torch/ops/rng.py) against the
JAX sweep's interpret-mode software stream, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.gillespie_pallas import _hash32
from bayesssm_tpu_torch.ops.rng import (
    SweepRng,
    hash32,
    lane_keys,
    mul32,
    uniform_blocks,
)

torch.set_num_threads(1)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_hash32_matches_jax_on_10k_words():
    x = _words(10_000, 0)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(_hash32(jnp.asarray(x)))
    got = hash32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


def test_mul32_wraps_like_uint32():
    x = _words(1000, 1).astype(np.uint64)
    for k in (0x9E3779B9, 0x85EBCA6B, 0x846CA68B, 1, 0xFFFFFFFF):
        want = (x * np.uint64(k)) & np.uint64(0xFFFFFFFF)
        got = mul32(torch.as_tensor(x.astype(np.int64)), k).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


def _jax_blocks(s0, s1, n, ctr, nblk):
    """The JAX kernel's software draw (sweep_builder.py:185-224) for one
    chain at program id 0, row 0, written out with jnp uint32 ops."""
    u32 = jnp.uint32
    s0w, s1w = u32(s0), u32(s1)
    base = _hash32(s0w ^ _hash32(s1w ^ _hash32(u32(0))))
    lane = jnp.arange(n, dtype=jnp.uint32)
    lane_mix = _hash32(base + lane * u32(0x9E3779B9))
    sd0 = jnp.asarray(np.uint32(s0).view(np.int32))
    sd1 = jnp.asarray(np.uint32(s1).view(np.int32))
    rmix = sd0 ^ (sd1 * jnp.int32(-1640531527) + jnp.int32(1))
    rmix = rmix ^ ((rmix >> 16) & jnp.int32(0x0000FFFF))
    rmix = rmix * jnp.int32(0x7FEB352D)
    rmix = rmix ^ ((rmix >> 15) & jnp.int32(0x0001FFFF))
    rmix = rmix * jnp.int32(-2073254261)
    rm = rmix.astype(jnp.uint32)
    bits = jnp.stack([
        _hash32((lane_mix ^ rm) ^ ((u32(ctr) + u32(k)) * u32(0x85EBCA6B)))
        for k in range(nblk)
    ])
    u24 = (bits >> u32(8)).astype(jnp.int32)
    return np.asarray(u24.astype(jnp.float32) * np.float32(1.0 / (1 << 24)))


@pytest.mark.parametrize("seed,ctr", [(0, 0), (1, 7), (2, 123456)])
def test_uniform_blocks_match_jax_stream(seed, ctr):
    s = _words(2 * 4, seed).reshape(4, 2)
    words = torch.as_tensor(s.astype(np.int64))
    keys = lane_keys(words, 128)
    got = uniform_blocks(
        keys, torch.full((4, 1), ctr, dtype=torch.int64), 3
    ).numpy()
    for c in range(4):
        want = _jax_blocks(int(s[c, 0]), int(s[c, 1]), 128, ctr, 3)
        np.testing.assert_array_equal(got[:, c], want)


def test_sweep_rng_threads_one_counter_per_chain():
    words = torch.as_tensor(_words(6, 3).reshape(3, 2).astype(np.int64))
    rng = SweepRng(lane_keys(words, 128))
    a = rng.uniform()
    rng.normal()
    assert rng.counter().flatten().tolist() == [3, 3, 3]
    blocks, ctr = rng.raw_uniform_blocks(2, rng.counter())
    assert ctr.flatten().tolist() == [5, 5, 5]
    assert rng.counter().flatten().tolist() == [3, 3, 3]
    # Chain rows draw independently: row 1 alone gives the same numbers.
    solo = SweepRng(lane_keys(words[1:2], 128))
    np.testing.assert_array_equal(solo.uniform().numpy()[0], a.numpy()[1])
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
