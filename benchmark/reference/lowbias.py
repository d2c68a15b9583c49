"""The lowbias32 counter streams of the system under test, restated.

Two streams, both of 32-bit words held in int64 tensors with every
product reduced mod 2**32 through 16-bit halves:

* the whole-sweep lane stream (a chain's two seed words, lane ``l``, a
  draw counter ``k`` that each chain threads through its filter):

      row_mix  = partial lowbias32 of s0 ^ (s1 * 0x9E3779B9 + 1)
      base     = hash(s0 ^ hash(s1 ^ hash(0)))
      lane_key = hash(base + l * 0x9E3779B9) ^ row_mix
      u        = (hash(lane_key ^ (k * 0x85EBCA6B)) >> 8) * 2**-24

  and the fused weight step's position uniforms, the same words with the
  row mix inside the hash and no counter;
* the MH stream: chain words from a root seed, then per MH step ``s``
  and word ``j``

      k_s    = hash(w0 ^ hash(w1 + s * 0x85EBCA6B))
      word_j = hash(k_s ^ hash((j + 1) * 0x9E3779B9))

  words 0 and 1 seed the step's filter, words ``2 + 2q`` and ``3 + 2q``
  give the ``q``-th proposal normal by Box-Muller, word ``2 + 2P`` the
  accept uniform.

Imports nothing but torch.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
STEP_MUL = 0x85EBCA6B
INV24 = 1.0 / (1 << 24)
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def mul32(x, k: int):
    """``x * k mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``k`` in [0, 2**32)."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x):
    """The lowbias32 finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _row_mix(s0, s1):
    r = s0 ^ ((mul32(s1, GOLDEN) + 1) & MASK32)
    r = r ^ (r >> 16)
    r = mul32(r, 0x7FEB352D)
    r = r ^ (r >> 15)
    return mul32(r, 0x846CA68B)


def _base(seed_words, n: int):
    s0 = seed_words[:, 0:1] & MASK32
    s1 = seed_words[:, 1:2] & MASK32
    base = hash32(s0 ^ hash32(s1 ^ hash32(torch.zeros_like(s1))))
    lane = torch.arange(n, dtype=torch.int64, device=seed_words.device)
    return (base + mul32(lane, GOLDEN)[None, :]) & MASK32, _row_mix(s0, s1)


def lane_keys(seed_words, n: int):
    """``[C, n]`` lane keys of chain words ``[C, 2]``."""
    base, mix = _base(seed_words, n)
    return hash32(base) ^ mix


def position_uniforms(seed_words, n: int):
    """``[C, n]`` float32 uniforms of the fused weight step's positions."""
    base, mix = _base(seed_words, n)
    return (hash32(base ^ mix) >> 8).to(torch.float32) * INV24


def uniform_blocks(keys, ctr, nblk: int):
    """``[nblk, C, N]`` float32 uniforms at counters ``ctr .. ctr + nblk -
    1`` (``ctr`` is ``[C, 1]`` int64)."""
    out = []
    for k in range(nblk):
        bits = hash32(keys ^ mul32((ctr + k) & MASK32, STEP_MUL))
        out.append((bits >> 8).to(torch.float32) * INV24)
    return torch.stack(out)


def box_muller(u0, u1):
    """One standard normal from two uniforms."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u0))
    return r * torch.cos(TWO_PI_F32 * u1)


def word_uniform(word):
    return (word >> 8).to(torch.float32) * INV24


def chain_words(seed: int, num_chains: int, device):
    """``[C, 2]`` chain words of the MH stream from an integer root seed."""
    r0 = int(seed) & MASK32
    r1 = (int(seed) >> 32) & MASK32
    cid = torch.arange(num_chains, dtype=torch.int64, device=device)
    w0 = hash32(r0 ^ hash32((r1 + mul32(cid, GOLDEN)) & MASK32))
    w1 = hash32(w0 ^ mul32(cid + 1, STEP_MUL))
    return torch.stack([w0, w1], dim=1)


def step_words(words, step, count: int):
    """``[C, count]`` words of MH step ``step``: an int, or a ``[C]`` int64
    tensor of one step per chain."""
    if isinstance(step, torch.Tensor):
        s_mix = mul32(step.to(torch.int64) & MASK32, STEP_MUL)
    else:
        s_mix = mul32(torch.tensor(int(step), dtype=torch.int64),
                      STEP_MUL).item()
    k = hash32(words[:, 0] ^ hash32((words[:, 1] + s_mix) & MASK32))
    j = torch.arange(1, count + 1, dtype=torch.int64, device=words.device)
    return hash32(k[:, None] ^ hash32(mul32(j, GOLDEN))[None, :])
