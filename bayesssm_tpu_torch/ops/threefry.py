"""Threefry-2x32 keys and draws, batched over chains.

The counterpart of the ``jax.random`` key operations the generic filter
engine (``filters/core.py``) relies on, so that the port draws, chain by
chain, the numbers the JAX engine draws for the same key:

* :func:`threefry2x32` — the 20-round Threefry-2x32 block function
  (``jax/_src/prng.py::_threefry2x32_lowering``);
* :func:`key` — ``jax.random.key(seed)``'s key data ``(0, seed mod 2**32)``;
* :func:`split` — the partitionable ``_threefry_split_foldlike``: key ``i``
  of ``split(k, shape)`` (row-major flat index ``i``) is
  ``threefry2x32(k, (i >> 32, i mod 2**32))``;
* :func:`fold_in` — ``threefry2x32(k, (0, data))``;
* :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32 bits:
  the xor of the two output words at the flat-index counters;
* :func:`uniform` and :func:`normal` — ``jax/_src/random.py::_uniform``
  (23 random mantissa bits under the exponent of 1.0, minus 1, scaled by
  one fused multiply-add, floored at ``minval``) and ``_normal_real`` (``sqrt(2) * erfinv(u)`` with
  ``u`` uniform on ``(nextafter(-1, 0), 1)``);
* :func:`randint` — ``_randint`` for int32: two 32-bit blocks from the
  two halves of ``split(key)``, folded into the span with uint32
  arithmetic.

Everything here follows JAX's partitionable threefry
(``jax_threefry_partitionable=True``, the default of the JAX versions the
tests run against); the tests pin that setting.

Keys are ``[..., 2]`` int64 tensors that hold uint32 words (the
``jax.random.key_data`` of each chain's key); every function maps over the
leading axes, so a ``[C, 2]`` batch of chain keys gives ``[C, *shape]``
draws. Words are kept in int64 with every sum and rotation reduced mod
2**32, so no operation overflows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesssm_tpu_torch.ops.rng import MASK32, mul32

__all__ = [
    "threefry2x32",
    "key",
    "as_key_words",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "randint",
    "erfinv",
    "normal",
]

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# erf_inv coefficients for w = -log1p(-x^2) below and above 5.
_ERFINV_SMALL_W = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_LARGE_W = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 of counter words ``(c0, c1)`` under key ``(k0, k1)``;
    all four broadcast against each other. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The ``[2]`` key words of ``jax.random.key(seed)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def as_key_words(keys, device=None) -> torch.Tensor:
    """int64 key words from a tensor or array of uint32 (or int64) words."""
    if isinstance(keys, torch.Tensor):
        words = keys.to(dtype=torch.int64, device=device)
    else:
        words = torch.as_tensor(
            np.asarray(keys).astype(np.uint32).astype(np.int64),
            device=device)
    if words.shape[-1:] != (2,):
        raise ValueError(
            f"key words must have a trailing axis of 2 (got shape "
            f"{tuple(words.shape)})")
    return words & MASK32


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(s) for s in shape)


def _blocks(keys: torch.Tensor, shape: tuple):
    """Threefry of every flat index of ``shape`` under every key."""
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k1 = keys[..., 1].reshape(lead + (1,) * len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    return threefry2x32(k0, k1, idx >> 32, idx & MASK32)


def split(keys: torch.Tensor, shape=2) -> torch.Tensor:
    """``[..., *shape, 2]`` subkeys (``jax.random.split(key, shape)``)."""
    b0, b1 = _blocks(keys, _shape(shape))
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every key. ``data`` is an int
    or an integer tensor that broadcasts against the keys' leading axes:
    ``fold_in(root [2], arange(C))`` gives the ``[C, 2]`` chain keys."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``[..., *shape]`` uint32 words in int64 (32-bit ``random_bits``)."""
    b0, b1 = _blocks(keys, _shape(shape))
    return b0 ^ b1


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)`` (``jax.random.uniform``)."""
    bits = random_bits(keys, shape)
    floats = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    if span == 1.0 and lo == 0.0:
        return floats
    return torch.clamp_min(_fma(floats, float(span), float(lo)), float(lo))


def randint(keys: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """int32 integers on ``[minval, maxval)`` (``jax.random.randint`` with
    the default int32 dtype). ``minval``/``maxval`` are ints or integer
    tensors that broadcast against ``[..., *shape]``.

    The bounds are clipped to the int32 range; ``maxval <= minval`` gives
    ``minval``. Two blocks ``hi``, ``lo`` are folded into the span as
    ``((hi % span) * (2**32 % span) + lo % span) % span`` in wrapping
    uint32 arithmetic, with ``2**32 % span`` taken as ``(2**16 % span)**2
    % span``; a span that wraps to 0 leaves the sum as it is."""
    shape = _shape(shape)
    dev = keys.device

    def bound(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev)

    lo_raw, hi_raw = bound(minval), bound(maxval)
    lo = lo_raw.clamp(_INT32_MIN, _INT32_MAX)
    hi = hi_raw.clamp(_INT32_MIN, _INT32_MAX)
    k1, k2 = split(keys).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (hi - lo) & MASK32
    span = torch.where(hi <= lo, 1, span)
    span = torch.where((hi_raw > _INT32_MAX) & (hi > lo), (span + 1) & MASK32,
                       span)

    def rem(x, m):
        # XLA's unsigned remainder by zero returns the dividend.
        return torch.where(m == 0, x, torch.remainder(x, torch.where(
            m == 0, 1, m)))

    mult = rem(torch.full_like(span, 1 << 16), span)
    mult = rem(mul32(mult, mult), span)
    offset = rem((mul32(rem(higher, span), mult) + rem(lower, span)) & MASK32,
                 span)
    out = (lo + offset) & MASK32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's fused multiply-add:
    the float64 product of two float32 values is exact."""
    return (a.double() * b + c).to(torch.float32)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function by the polynomial XLA expands
    ``erf_inv`` into (Giles' single-precision approximation, Horner steps
    as fused multiply-adds), which keeps the draws within a few ulps of
    JAX's; ``torch.special.erfinv`` uses another approximation and differs
    by up to about 1e-5."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL_W[0], _ERFINV_LARGE_W[0])
    for lo, hi in zip(_ERFINV_SMALL_W[1:], _ERFINV_LARGE_W[1:]):
        p = _fma(p, w, torch.where(small, lo, hi).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """float32 standard normals (``jax.random.normal``)."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0)
    return _SQRT2_F32 * erfinv(u)
