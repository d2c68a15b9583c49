"""Counter-based lowbias32 stream shared by the sweep twin and its kernel.

Port of the software stream that ``bayesssm_tpu/ops/sweep_builder.py``
draws from when its kernel runs under the Pallas interpreter
(``_make_kernel``'s ``software_prng`` branch, :185-224), specialised to one
chain per program: program id 0 and row 0. For chain words ``(s0, s1)``
(the bitcast of ``jax.random.key_data(key)[:2]``), lane ``l`` and draw
counter ``k``:

    row_mix  = partial lowbias32 of s0 ^ (s1 * 0x9E3779B9 + 1)
    base     = hash(s0 ^ hash(s1 ^ hash(0)))
    lane_key = hash(base + l * 0x9E3779B9) ^ row_mix
    bits     = hash(lane_key ^ (k * 0x85EBCA6B))
    u        = (bits >> 8) * 2**-24                       in [0, 1)

Each chain threads its own counter ``k`` through the sweep (the
``SweepRng`` draw schedule, :72-133), so a chain's draws depend only on
its two words, its lanes and how many blocks it has drawn — never on the
other chains of the batch. :meth:`SweepRng.event_loop` runs a callback's
own loop on that counter, as the JAX builder's callbacks thread it
through a ``lax.while_loop``. The CUDA kernel computes the same words with
``uint32_t`` arithmetic (``csrc/rng.cuh``); here they are int64 tensors
holding uint32 values, with every product reduced mod 2**32 through
16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

import math

import torch

from bayesssm_tpu_torch.utils.timing import count

__all__ = [
    "MASK32",
    "hash32",
    "mul32",
    "lane_keys",
    "uniform_blocks",
    "position_uniforms",
    "box_muller",
    "SweepRng",
]

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_CTR_MUL = 0x85EBCA6B
_INV24 = 1.0 / (1 << 24)
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``k`` in [0, 2**32), without an int64 product above 2**48."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (``ops/gillespie_pallas.py::_hash32``)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _row_mix(s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """The per-chain mix of ``sweep_builder.py:189-193`` (int32 there:
    wrapping multiplies and masked shifts are uint32 arithmetic)."""
    r = s0 ^ ((mul32(s1, _GOLDEN) + 1) & MASK32)
    r = r ^ (r >> 16)
    r = mul32(r, 0x7FEB352D)
    r = r ^ (r >> 15)
    return mul32(r, 0x846CA68B)


def lane_keys(seed_words: torch.Tensor, n: int) -> torch.Tensor:
    """Per-lane stream keys ``[C, n]`` for chain words ``[C, 2]``."""
    s0 = seed_words[:, 0:1] & MASK32
    s1 = seed_words[:, 1:2] & MASK32
    base = hash32(s0 ^ hash32(s1 ^ hash32(torch.zeros_like(s1))))
    lane = torch.arange(n, dtype=torch.int64, device=seed_words.device)
    lane_mix = hash32((base + mul32(lane, _GOLDEN)[None, :]) & MASK32)
    return lane_mix ^ _row_mix(s0, s1)


def position_uniforms(seed_words: torch.Tensor, n: int) -> torch.Tensor:
    """``[C, n]`` f32 uniforms of the fused weight step's in-kernel
    positions (``ops/resampling_pallas.py::_kernel``, :156-166, one chain
    per program): ``hash((base + l * 0x9E3779B9) ^ row_mix) >> 8`` times
    2**-24. Unlike :func:`lane_keys`, the row mix sits inside the hash and
    there is no draw counter."""
    s0 = seed_words[:, 0:1] & MASK32
    s1 = seed_words[:, 1:2] & MASK32
    base = hash32(s0 ^ hash32(s1 ^ hash32(torch.zeros_like(s1))))
    lane = torch.arange(n, dtype=torch.int64, device=seed_words.device)
    bits = hash32(((base + mul32(lane, _GOLDEN)[None, :]) & MASK32)
                  ^ _row_mix(s0, s1))
    return (bits >> 8).to(torch.float32) * _INV24


def uniform_blocks(keys: torch.Tensor, ctr: torch.Tensor, nblk: int):
    """``nblk`` uniform blocks ``[nblk, C, N]`` f32 drawn at counters
    ``ctr .. ctr + nblk - 1`` (``ctr`` is ``[C, 1]`` int64, one per chain)."""
    out = []
    for k in range(nblk):
        bits = hash32(keys ^ mul32((ctr + k) & MASK32, _CTR_MUL))
        out.append((bits >> 8).to(torch.float32) * _INV24)
    return torch.stack(out)


def box_muller(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    """One standard normal from two uniforms (``SweepRng.normal``)."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u0))
    return r * torch.cos(TWO_PI_F32 * u1)


class SweepRng:
    """Batched twin of the JAX ``SweepRng`` handle: every chain row carries
    its own draw counter (``[C, 1]`` int64).

    A callback runs a loop of its own, such as an exact event simulator,
    through :meth:`event_loop`, which the sweep tracer also takes, so that
    the loop runs inside K1 on a card. The hand-written SIR event loop
    threads the counter explicitly instead (:meth:`counter`,
    :meth:`raw_uniform_blocks`, :meth:`set_counter`), which runs in the
    plain sweep only.
    """

    def __init__(self, keys: torch.Tensor, ctr: torch.Tensor | None = None):
        self.keys = keys
        self._ctr = (
            torch.zeros((keys.shape[0], 1), dtype=torch.int64,
                        device=keys.device)
            if ctr is None else ctr
        )
        self._looping = False

    def _draw(self, what: str) -> None:
        if self._looping:
            raise ValueError(
                f"{what} inside rng.event_loop's cond_fn or body_fn: the "
                "body takes its uniforms as its first argument")

    def uniform(self) -> torch.Tensor:
        self._draw("rng.uniform()")
        u = uniform_blocks(self.keys, self._ctr, 1)[0]
        self._ctr = self._ctr + 1
        return u

    def uniforms(self, k: int) -> torch.Tensor:
        self._draw("rng.uniforms()")
        u = uniform_blocks(self.keys, self._ctr, int(k))
        self._ctr = self._ctr + int(k)
        return u

    def normal(self) -> torch.Tensor:
        self._draw("rng.normal()")
        u = self.uniforms(2)
        return box_muller(u[0], u[1])

    def counter(self) -> torch.Tensor:
        return self._ctr

    def set_counter(self, ctr: torch.Tensor) -> None:
        self._ctr = ctr

    def raw_uniform_blocks(self, nblk: int, ctr: torch.Tensor):
        """``(blocks [nblk, C, N], ctr + nblk)``; the handle's own counter
        is left alone."""
        return uniform_blocks(self.keys, ctr, nblk), ctr + nblk

    def event_loop(self, cond_fn, body_fn, carry, *, draws: int,
                   max_iters: int):
        """A loop of the callback's own: the final carry.

        ``carry`` is a tuple of ``[C, N]`` float32 columns, ``cond_fn(carry)``
        a lane's bool "still running" and ``body_fn(u, carry)`` the new
        carry, ``u`` a tuple of ``draws`` uniform blocks. Both may read
        values closed over from the callback, and neither may draw from
        this handle. Iteration ``k`` of chain ``c`` runs while some lane of
        ``c`` satisfies ``cond_fn`` and ``k < max_iters``; it draws its
        blocks at counters ``ctr + draws * k``, and lanes whose condition
        is false keep their carry. Afterwards the chain's counter is ``ctr
        + draws * K_c``, ``K_c`` the iterations it ran. As ``cond_fn``
        reads only the carry, a lane that has stopped stays stopped, so a
        lane may equally loop on its own (K1's generated functor does).

        Counts ``sweep.loop_iters`` (the lanes' own iterations, those in
        which their condition held) and ``sweep.loop_slots`` (``K_c``
        times the chain's lanes, summed over the chains).
        """
        draws, max_iters = int(draws), int(max_iters)
        if draws < 1 or max_iters < 0:
            raise ValueError("event_loop needs draws >= 1 and max_iters >= 0")
        if self._looping:
            raise ValueError("a nested rng.event_loop: a callback's loop "
                             "may not hold another")
        carry = tuple(carry)
        ran = torch.zeros_like(self._ctr)
        iters = torch.zeros((), dtype=torch.int64, device=self.keys.device)
        self._looping = True
        try:
            for k in range(max_iters):
                live = cond_fn(carry)
                go = live.any(dim=1, keepdim=True)
                if not bool(go.any()):
                    break
                u = uniform_blocks(self.keys, self._ctr + draws * k, draws)
                new = tuple(body_fn(tuple(u), carry))
                if len(new) != len(carry):
                    raise ValueError(
                        f"event_loop's body_fn must return {len(carry)} "
                        f"columns (got {len(new)})")
                carry = tuple(torch.where(live, x, c)
                              for x, c in zip(new, carry))
                ran = ran + go
                iters = iters + live.sum()
        finally:
            self._looping = False
        self._ctr = self._ctr + draws * ran
        count("sweep.loop_iters", int(iters))
        count("sweep.loop_slots", int(ran.sum()) * self.keys.shape[1])
        return carry
