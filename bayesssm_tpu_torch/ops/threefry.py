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
  arithmetic;
* :func:`binomial` — ``_binomial`` of JAX 0.9: the inversion algorithm
  (``_binomial_inversion``) where ``count * q <= 10``, else BTRS
  (``_btrs`` with ``_stirling_approx_tail``), each a while loop that splits
  its carried key once per iteration.

Everything here follows JAX's partitionable threefry
(``jax_threefry_partitionable=True``, the default of the JAX versions the
tests run against); the tests pin that setting.

Keys are ``[..., 2]`` int64 tensors that hold uint32 words (the
``jax.random.key_data`` of each chain's key); every function maps over the
leading axes, so a ``[C, 2]`` batch of chain keys gives ``[C, *shape]``
draws. Keys and the words the functions return are int64 with every
value in [0, 2**32); the rounds run on int32 words, whose sums wrap mod
2**32, in place on the output words (``_threefry_i32``).

Where the draws run follows the keys' device. On a CUDA device
:func:`split`, :func:`fold_in`, :func:`random_bits`, :func:`uniform`,
:func:`normal` and :func:`binomial`'s lane uniforms are one launch each of
the kernel ``csrc/threefry.cu`` (``_build.launch_threefry``), bit for bit
with the code here, or raise; elsewhere they run the code here, the
kernel's plain twin. Under ``torch.func.vmap`` (a move written for one
particle, ``utils/signatures.py::adapt_move_fn``) the launch goes through
the operator ``bssm::threefry``, whose vmap rule makes a draw one launch
for the whole batch. Counters (``utils/timing.py``): ``threefry.kernel``, a
launch of the kernel; ``threefry.plain``, a call that ran the plain twin
(one of those six on keys off the card). :func:`randint`,
:func:`binomial` and :class:`LoopKeys` draw through them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.rng import MASK32, mul32
from bayesssm_tpu_torch.utils.timing import count, host_sync

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
    "binomial",
    "LoopKeys",
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


def _as_i32(v):
    """uint32 words (an int64 tensor or an int) as int32 two's complement."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    v = int(v) & MASK32
    return v - (1 << 32) if v >> 31 else v


def _threefry_i32(k0, k1, c0, c1):
    """:func:`threefry2x32` on int32 words: int32 sums wrap mod 2**32, and
    ``>>`` is arithmetic, so a rotation masks the bits the sign shifts in.
    The rounds run in place on the two ``[*broadcast]`` output words."""
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


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as uint32 values in int64."""
    return x.to(torch.int64) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 of counter words ``(c0, c1)`` under key ``(k0, k1)``;
    all four broadcast against each other. Returns the two output words."""
    x0, x1 = _threefry_i32(k0, k1, c0, c1)
    return _u32(x0), _u32(x1)


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


def _on_card(keys: torch.Tensor) -> bool:
    """Whether draws from these key words run as the kernel: on a CUDA
    device."""
    return keys.device.type == "cuda"


_batched = torch._C._functorch.is_batchedtensor
_LIB = torch.library.Library("bssm", "DEF")
_LIB.define("threefry(Tensor keys, str form, int[] shape, Tensor? data, "
            "int data_word, float lo, float span) -> Tensor")


def _threefry_op(keys, form, shape, data, data_word, lo, span):
    """``bssm::threefry``: one ``_build.launch_threefry``, whose ``data``
    is the tensor ``data`` or else the int ``data_word``."""
    return _build.launch_threefry(keys, form, tuple(shape),
                                  data=data_word if data is None else data,
                                  lo=lo, span=span)


def _threefry_vmap(info, in_dims, keys, form, shape, data, data_word, lo,
                   span):
    """vmap rule of ``bssm::threefry``: the batch axis goes in front of the
    leading axes of the key words (and of the data, which broadcast
    against them from the right), which one launch maps over; the draws
    come out batched at axis 0."""
    b = info.batch_size

    def front(x, dim):
        return x.movedim(dim, 0) if dim is not None else x.expand(b, *x.shape)

    keys = front(keys, in_dims[0])
    if data is not None:
        data = front(data, in_dims[3])
        k, d = keys.ndim - 2, data.ndim - 1
        keys = keys.reshape(b, *(1,) * (d - k), *keys.shape[1:])
        data = data.reshape(b, *(1,) * (k - d), *data.shape[1:])
    return torch.ops.bssm.threefry(keys, form, shape, data, data_word, lo,
                                   span), 0


_LIB.impl("threefry", _threefry_op, "CompositeExplicitAutograd")
torch.library.register_vmap("bssm::threefry", _threefry_vmap, lib=_LIB)


def _kernel(keys: torch.Tensor, form: str, shape=(), data=None, lo=0.0,
            span=1.0) -> torch.Tensor:
    """One launch of ``csrc/threefry.cu``; ``data`` is an int, an int64
    tensor or ``None``. Under vmap (batched keys or data) it goes through
    ``bssm::threefry`` and its vmap rule; otherwise straight to the
    launcher, which spares the dispatcher's round trip through Python
    (~28 µs of host issue a draw on an H100 machine's host)."""
    word = 0
    if not isinstance(data, torch.Tensor):
        word, data = (0 if data is None else int(data) & MASK32), None
    shape = list(shape)
    if _batched(keys) or (data is not None and _batched(data)):
        return torch.ops.bssm.threefry(keys, form, shape, data, word,
                                       float(lo), float(span))
    return _threefry_op(keys, form, shape, data, word, lo, span)


def _blocks(keys: torch.Tensor, shape: tuple):
    """Threefry of every flat index of ``shape`` under every key, as int32
    words (:func:`_threefry_i32`)."""
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k1 = keys[..., 1].reshape(lead + (1,) * len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    return _threefry_i32(k0, k1, idx >> 32, idx & MASK32)


def split(keys: torch.Tensor, shape=2) -> torch.Tensor:
    """``[..., *shape, 2]`` subkeys (``jax.random.split(key, shape)``)."""
    if _on_card(keys):
        return _kernel(keys, "split", _shape(shape))
    count("threefry.plain")
    b0, b1 = _blocks(keys, _shape(shape))
    return torch.stack([_u32(b0), _u32(b1)], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every key. ``data`` is an int
    or an integer tensor that broadcasts against the keys' leading axes:
    ``fold_in(root [2], arange(C))`` gives the ``[C, 2]`` chain keys."""
    if _on_card(keys):
        if isinstance(data, torch.Tensor):
            data = data.to(device=keys.device, dtype=torch.int64)
        return _kernel(keys, "fold_in", data=data)
    count("threefry.plain")
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``[..., *shape]`` uint32 words in int64 (32-bit ``random_bits``)."""
    if _on_card(keys):
        return _kernel(keys, "bits", _shape(shape))
    count("threefry.plain")
    b0, b1 = _blocks(keys, _shape(shape))
    return _u32(b0 ^ b1)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)`` (``jax.random.uniform``)."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    if _on_card(keys):
        return _kernel(keys, "uniform", _shape(shape), lo=float(lo),
                       span=float(span))
    count("threefry.plain")
    return _uniform_plain(keys, _shape(shape), lo, span)


def _uniform_plain(keys, shape, lo, span):
    """The plain twin of :func:`uniform` at float32 ``lo`` and ``span``."""
    b0, b1 = _blocks(keys, shape)
    floats = _to_uniform(b0 ^ b1)
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
    if _on_card(keys):
        return _kernel(keys, "normal", _shape(shape))
    count("threefry.plain")
    lo = np.float32(_NORMAL_LO)
    u = _uniform_plain(keys, _shape(shape), lo, np.float32(1.0) - lo)
    return _SQRT2_F32 * erfinv(u)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 on [0, 1) from 32-bit words, int32 or uint32 in int64
    (``uniform``'s mantissa fill)."""
    return (((bits >> 9) & 0x7FFFFF) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32) - 1.0


class LoopKeys:
    """The subkeys of a JAX ``while_loop`` whose body splits its carried
    key into ``num`` at the top of every iteration, keeps entry ``carry``
    and draws with the others: ``binomial``'s inversion loop
    (``subkey, key = split(key)``: ``num=2, carry=1``) and its BTRS loop
    (``key, sub0, sub1 = split(key, 3)``: ``num=3, carry=0``).

    ``keys [R, 2]`` are the loops' starting keys, one per row; iterations
    are split once, on first use, for every row at once, so the loops of
    many rows that run one after another (the binomials of a tau-leaping
    day) share one chain of splits through views (:meth:`rows`).
    """

    def __init__(self, keys: torch.Tensor, num: int, carry: int):
        self._key = keys
        self._num = num
        self._carry = carry
        self._subs = []         # per iteration: [R, num - 1, 2]

    def subkeys(self, lo: int, hi: int, rows: torch.Tensor) -> torch.Tensor:
        """``[len(rows), hi - lo, num - 1, 2]`` subkeys of iterations
        ``lo .. hi - 1`` of the given rows."""
        keep = [j for j in range(self._num) if j != self._carry]
        while len(self._subs) < hi:
            s = split(self._key, self._num)
            self._key = s[:, self._carry]
            self._subs.append(s[:, keep])
        return torch.stack(self._subs[lo:hi], dim=1)[rows]

    def rows(self, row_map: torch.Tensor) -> "_LoopRows":
        """The view whose row ``r`` is this chain's row ``row_map[r]``."""
        return _LoopRows(self, row_map)


class _LoopRows:
    def __init__(self, loop: LoopKeys, row_map: torch.Tensor):
        self._loop = loop
        self._row_map = row_map

    def subkeys(self, lo: int, hi: int, rows: torch.Tensor) -> torch.Tensor:
        return self._loop.subkeys(lo, hi, self._row_map[rows])


# BTRS's Stirling tail table (``_stirling_approx_tail``), float32, and its
# copy on each device.
_STIRLING_TAIL = tuple(float(np.float32(v)) for v in (
    0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
    0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
    0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
    0.00833056343336287))
_STIRLING_ON = {}
# Iterations per block of the two loops between checks of termination.
_INVERSION_BLOCK = 4
_BTRS_BLOCK = 4


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """JAX's ``_stirling_approx_tail``: the table for ``k <= 9``, else the
    series at ``k`` clamped to [0, 9] (as JAX evaluates it)."""
    if k.device not in _STIRLING_ON:
        _STIRLING_ON[k.device] = torch.tensor(_STIRLING_TAIL,
                                              dtype=torch.float32,
                                              device=k.device)
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    # A NaN k takes the series (NaN) and must not index the table.
    idx = torch.floor(torch.where(use_table, k, 0.0)).long()
    return torch.where(use_table, _STIRLING_ON[k.device][idx], approx)


def _lane_uniforms(sub: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``uniform(sub, shape)[lane]``: uniforms drawn with subkeys
    ``sub [..., 2]`` at flat lane indices ``lanes`` (int64 in [0, 2**32),
    broadcast together): on a CUDA device one launch of the kernel, whose
    counter ``(0, lane)`` is the plain twin's ``(lane >> 32, lane)``."""
    if _on_card(sub):
        return _kernel(sub, "lane_uniform", data=lanes)
    count("threefry.plain")
    b0, b1 = _threefry_i32(sub[..., 0], sub[..., 1], lanes >> 32,
                           lanes & MASK32)
    return _to_uniform(b0 ^ b1)


def _binomial_inversion(loop: LoopKeys, count, log1mp, active):
    """``_binomial_inversion`` on ``[R, L]`` rows (``L`` lanes each), run
    for the ``active`` lanes only. A lane stops counting once its
    geometric sum passes ``count``, and later iterations leave it as it
    is; so each lane runs until it stops, in blocks, with the lanes still
    running gathered at each block. Returns ``num_geom - 1``."""
    r, lanes = count.shape
    geom_sum = torch.zeros(r * lanes, dtype=count.dtype, device=count.device)
    num_geom = torch.zeros_like(geom_sum)
    cnt, l1p = count.reshape(-1), log1mp.reshape(-1)
    host_sync(count)
    idx = torch.nonzero((active & (count >= 0)).reshape(-1))[:, 0]
    lo = 0
    while idx.numel():
        hi = lo + _INVERSION_BLOCK
        sub = loop.subkeys(lo, hi, idx // lanes)[:, :, 0]      # [M, B, 2]
        u = _lane_uniforms(sub, (idx % lanes)[:, None])        # [M, B]
        geom = torch.ceil(torch.log(u) / l1p[idx, None])
        g, k, c = geom_sum[idx], num_geom[idx], cnt[idx]
        for j in range(hi - lo):
            k = torch.where(g <= c, k + 1, k)
            g = g + geom[:, j]
        geom_sum[idx] = g
        num_geom[idx] = k
        host_sync(idx)
        idx = idx[g <= c]
        lo = hi
    return (num_geom - 1).reshape(r, lanes)


def _btrs(loop: LoopKeys, count, prob, rows):
    """``_btrs`` on ``[R, L]`` rows, run for ``rows`` only. A row's loop
    stops at the first iteration after which every lane has accepted
    once, and each accepting iteration before that overwrites the lane's
    draw; so each row runs exactly its own iterations (the rest of a block
    leaves it as it is), in blocks, with the rows still running gathered
    at each block."""
    lanes = count.shape[1]
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    ratio = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    # The terms of the bound that do not change between iterations.
    m_term = (m + 0.5) * torch.log((m + 1) / (ratio * (count - m + 1)))
    m_tails = (_stirling_approx_tail(m), _stirling_approx_tail(count - m))
    k_out = torch.full_like(count, -1.0)
    accepted = torch.zeros_like(count, dtype=torch.bool)
    lane_idx = torch.arange(lanes, device=count.device)[None, :, None]
    lo = 0
    while rows.numel():
        hi = lo + _BTRS_BLOCK
        sub = loop.subkeys(lo, hi, rows)[:, None]      # [M, 1, B, 2, 2]
        u = _lane_uniforms(sub[..., 0, :], lane_idx)   # [M, L, B]
        v = _lane_uniforms(sub[..., 1, :], lane_idx)

        def at(x):
            return x[rows][..., None]

        n_, a_, b_, m_, r_ = at(count), at(a), at(b), at(m), at(ratio)
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= at(v_r))
        k = torch.floor((2 * a_ / us + b_) * u + at(c))
        reject = (k < 0) | (k > n_)
        v = torch.log(v * at(alpha) / (a_ / (us * us) + b_))
        ub = (at(m_term)
              + (n_ + 1) * torch.log((n_ - m_ + 1) / (n_ - k + 1))
              + (k + 0.5) * torch.log(r_ * (n_ - k + 1) / (k + 1))
              + at(m_tails[0])
              + at(m_tails[1])
              - _stirling_approx_tail(k)
              - _stirling_approx_tail(n_ - k))
        accept = accept1 | (~reject & (v <= ub))
        ko, acc = k_out[rows], accepted[rows]
        for j in range(hi - lo):
            upd = accept[..., j] & ~acc.all(dim=1, keepdim=True)
            ko = torch.where(upd, k[..., j], ko)
            acc = acc | upd
        k_out[rows] = ko
        accepted[rows] = acc
        host_sync(rows)
        rows = rows[~acc.all(dim=1)]
        lo = hi
    return k_out


def binomial(keys: torch.Tensor, count, prob,
             loops: tuple | None = None) -> torch.Tensor:
    """float32 Binomial(count, prob) draws (``jax.random.binomial`` of JAX
    0.9, float32): keys ``[..., 2]``, and ``count`` and ``prob`` broadcast
    together to ``[..., *shape]``, whose leading axes are the keys' (each
    key draws ``shape``, as ``jax.random.binomial(key, n, p)`` draws the
    broadcast of its ``n`` and ``p``).

    Each key's draws follow JAX's for that key alone (un-vmapped, or one
    row of a vmapped call): the inversion algorithm where ``count * q <=
    10`` (``q = min(p, 1 - p)``), BTRS elsewhere, ``NaN`` for a NaN or
    negative count or a NaN or negative ``q``, ``inf`` for an infinite
    count, and ``count - draw`` where ``p >= 0.5``. The inversion loop
    runs each lane until its geometric sum passes its count; the BTRS loop
    stops each key at the first iteration after which all its lanes have
    accepted, as JAX's ``while_loop`` does (an accepting iteration
    overwrites the draw, so the stop must be exact). Both run in blocks of
    iterations with one host sync per block.

    ``loops``: the two loops' :class:`LoopKeys` over ``keys`` flattened
    to ``[R, 2]`` (inversion ``num=2, carry=1``; BTRS ``num=3,
    carry=0``), to share their splits with other calls; built here if not
    given.
    """
    lead = tuple(keys.shape[:-1])
    dev = keys.device
    count = torch.as_tensor(count, dtype=torch.float32, device=dev)
    prob = torch.as_tensor(prob, dtype=torch.float32, device=dev)
    full = torch.broadcast_shapes(count.shape, prob.shape)
    if full[:len(lead)] != lead:
        raise ValueError(
            f"count and prob must broadcast to [*{list(lead)}, ...] for "
            f"keys of shape {tuple(keys.shape)} (got {tuple(full)})")
    r, lanes = math.prod(lead), math.prod(full[len(lead):])
    count = count.expand(full).reshape(r, lanes)
    prob = prob.expand(full).reshape(r, lanes)
    if loops is None:
        flat = keys.reshape(r, 2)
        loops = (LoopKeys(flat, 2, 1), LoopKeys(flat, 3, 0))

    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, 0.01, q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inversion, count, 0.0)
    count_btrs = torch.where(use_inversion, 1e4, count)
    q_btrs = torch.where(use_inversion, 0.5, q)

    samples = _binomial_inversion(loops[0], count_inv, torch.log1p(-q),
                                  use_inversion)
    host_sync(samples)
    btrs_rows = torch.nonzero((~use_inversion).any(dim=1))[:, 0]
    if btrs_rows.numel():
        samples = torch.where(use_inversion, samples,
                              _btrs(loops[1], count_btrs, q_btrs, btrs_rows))
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, math.nan, samples)
    samples = torch.where(count_inf & ~invalid, math.inf, samples)
    samples = torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                          samples, count - samples)
    return samples.reshape(full)
