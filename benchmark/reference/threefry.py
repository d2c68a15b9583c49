"""Threefry-2x32 keys and draws over a batch of chain keys, restated.

Keys are ``[..., 2]`` int64 tensors of uint32 words. ``split(k, shape)``'s
key ``i`` (row-major flat index) is ``threefry2x32(k, (i >> 32, i mod
2**32))``; ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``; 32-bit random
bits are the xor of the two output words at the flat-index counters;
``uniform`` puts 23 random mantissa bits under the exponent of 1.0 and
subtracts 1, scaled by one fused multiply-add and floored at ``minval``;
``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
``(nextafter(-1, 0), 1)`` and ``erfinv`` Giles' single-precision
polynomial with its Horner steps fused. These are the partitionable
threefry draws of ``jax.random``, which the system under test follows.

Imports nothing but torch and numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_ERFINV_SMALL_W = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_LARGE_W = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _as_i32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    v = int(v) & MASK32
    return v - (1 << 32) if v >> 31 else v


def _threefry_i32(k0, k1, c0, c1):
    """The 20 rounds on int32 words (sums wrap mod 2**32; a rotation masks
    the bits an arithmetic shift brings in)."""
    k0, k1, c0, c1 = (_as_i32(v) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    shape = torch.broadcast_shapes(x0.shape, x1.shape)
    x0 = x0.expand(shape).contiguous()
    x1 = x1.expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            low = (x1 >> (32 - r)).bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _u32(x):
    return x.to(torch.int64) & MASK32


def key(seed: int, device=None):
    """The ``[2]`` key words of an integer seed: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _blocks(keys, shape: tuple):
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k1 = keys[..., 1].reshape(lead + (1,) * len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    return _threefry_i32(k0, k1, idx >> 32, idx & MASK32)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(s) for s in shape)


def split(keys, shape=2):
    """``[..., *shape, 2]`` subkeys."""
    b0, b1 = _blocks(keys, _shape(shape))
    return torch.stack([_u32(b0), _u32(b1)], dim=-1)


def fold_in(keys, data):
    """``threefry2x32(k, (0, data))`` for every key; ``data`` an int or an
    integer tensor that broadcasts against the keys' leading axes."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    b0, b1 = _threefry_i32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([_u32(b0), _u32(b1)], dim=-1)


def _to_uniform(bits):
    return (((bits >> 9) & 0x7FFFFF) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32) - 1.0


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once."""
    return (a.double() * b + c).to(torch.float32)


def uniform(keys, shape=(), minval: float = 0.0, maxval: float = 1.0):
    """float32 uniforms on ``[minval, maxval)``."""
    b0, b1 = _blocks(keys, _shape(shape))
    floats = _to_uniform(b0 ^ b1)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    if span == 1.0 and lo == 0.0:
        return floats
    return torch.clamp_min(_fma(floats, float(span), float(lo)), float(lo))


def erfinv(x):
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL_W[0], _ERFINV_LARGE_W[0])
    for lo, hi in zip(_ERFINV_SMALL_W[1:], _ERFINV_LARGE_W[1:]):
        p = _fma(p, w, torch.where(small, lo, hi).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys, shape=()):
    """float32 standard normals."""
    return _SQRT2_F32 * erfinv(uniform(keys, shape, _NORMAL_LO, 1.0))
