"""Exact Gillespie SIR day-step (K4): the plain PyTorch version and its
CUDA kernel.

Port of ``bayesssm_tpu/ops/gillespie_pallas.py``: every particle lane of
every chain runs the SIR jump process over ``[0, t_end]`` — waiting times
``-log1p(-u) / rate_tot``, the event chosen by ``u' * rate_tot <
rate_inf``, ``unroll`` events per loop iteration, and a chain stops when
none of its lanes is active or after ``MAX_EVENTS`` events.

Draws: the chain's lowbias32 lane stream (``ops/rng.py``, the JAX kernel's
software stream for one chain per program) keyed by the chain's two key
words, with the counter restarted at 0 on every call; iteration ``k``
draws counters ``2 * unroll * k .. 2 * unroll * (k + 1) - 1``. So a chain's
day depends on its own key words and state alone, and
:func:`gillespie_step_reference` equals an un-vmapped interpret-mode
``gillespie_step_pallas`` call per key.

:func:`gillespie_day` is the batched event loop itself; the whole-sweep SIR
callback (``ops/sir_sweep.py``) runs the same function with its own
counter. The CUDA sweep and day-step kernels share its event body
(``csrc/models.cuh::sir_attempt``) but run each lane on its own
(``sir_lane``): a lane that is no longer active never fires again, so its
state depends on its own draws alone, and the chain's counter after the
day is ``ctr + 2 * unroll * max_l ceil(attempts_l / unroll)``
(``tests/test_torch_gillespie_lanes.py``).

:func:`gillespie_step` routes by device: CPU tensors take the plain
version, CUDA tensors launch ``bssm_gillespie`` (``csrc/gillespie.cu``) or
raise.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.rng import lane_keys, uniform_blocks
from bayesssm_tpu_torch.utils.timing import host_sync

__all__ = ["MAX_EVENTS", "EventTally", "gillespie_day", "gillespie_step",
           "gillespie_step_reference"]

# Cap on events per chain per call (ops/gillespie_pallas.py:52).
MAX_EVENTS = 100_000


class EventTally:
    """The work of the plain event loop while the tally is open (``with
    EventTally() as tally:``), for the kernels' bounds: a kernel runs the
    same loop over the same draws, so it needs the same events.

    * ``fired`` — events that happened, summed over lanes and calls (one
      call is one transition of a day);
    * ``block_max`` — over chain-calls, the sum of the largest event count
      of any lane of the chain (a block iterates until its last lane is
      done);
    * ``slots`` — lane-event slots the blocks run: every lane of a chain
      for each unrolled event while any of its lanes is active;
    * ``chain_calls`` and ``lanes`` — chains x calls, and lanes per chain.
    """

    _open: list = []

    def __init__(self):
        self.fired = self.block_max = self.slots = self.chain_calls = 0
        self.lanes = 0

    def __enter__(self):
        EventTally._open.append(self)
        return self

    def __exit__(self, *exc):
        EventTally._open.remove(self)

    def add(self, events: torch.Tensor, steps: torch.Tensor) -> None:
        c, n = events.shape
        self.fired += int(events.sum())
        self.block_max += int(events.amax(dim=1).sum())
        self.slots += int(steps.sum()) * n
        self.chain_calls += c
        self.lanes = n

    def summary(self) -> dict:
        """Events per lane per transition (mean, and the per-block
        maximum), and the tail: slots run per event needed."""
        calls = max(self.chain_calls, 1)
        return dict(
            events=self.fired,
            events_per_lane_transition=self.fired / (calls * self.lanes),
            block_max_events_per_lane_transition=self.block_max / calls,
            tail=self.slots / max(self.fired, 1),
        )


def gillespie_day(keys, ctr, s, i, lam_n, gam, t_end: float = 1.0,
                  unroll: int = 8):
    """The batched event loop: ``keys``, ``s``, ``i`` ``[C, N]``, ``ctr``
    ``[C, 1]`` int64 draw counters, ``lam_n`` (``lam / n_total``) and
    ``gam`` broadcastable to ``[C, N]``. Returns ``(s, i, ctr)``.

    All chains iterate together, but a chain's counter, event count and
    state move only on the iterations in which it still runs, exactly as
    one kernel block (or one un-batched JAX call) does alone.
    """
    tloc = torch.zeros_like(s)
    active = i > 0.0
    steps = torch.zeros_like(ctr)
    events = (torch.zeros_like(s, dtype=torch.int64) if EventTally._open
              else None)
    while True:
        go = active.any(dim=1, keepdim=True) & (steps < MAX_EVENTS)
        host_sync(go)
        if not bool(go.any()):
            break
        u = uniform_blocks(keys, ctr, 2 * unroll)
        for e in range(unroll):
            rate_inf = lam_n * s * i
            rate_tot = rate_inf + gam * i
            dt = -torch.log1p(-u[2 * e]) * (1.0 / rate_tot)
            t_new = tloc + dt
            fire = active & go & (t_new <= t_end)
            infect = u[2 * e + 1] * rate_tot < rate_inf
            s = torch.where(fire & infect, s - 1.0, s)
            i = torch.where(fire, torch.where(infect, i + 1.0, i - 1.0), i)
            tloc = torch.where(fire, t_new, tloc)
            active = fire & (i > 0.0)
            if events is not None:
                events += fire
        ctr = ctr + 2 * unroll * go
        steps = steps + unroll * go
    for tally in EventTally._open:
        tally.add(events, steps)
    return s, i, ctr


def _prepare(key_words, state, lam, gamma):
    state = torch.as_tensor(state, dtype=torch.float32).contiguous()
    if state.ndim != 3 or state.shape[2] != 2:
        raise ValueError(
            f"state must be [C, N, 2] (S, I) (got {tuple(state.shape)})")
    c = state.shape[0]
    dev = state.device
    words = torch.as_tensor(key_words, dtype=torch.int64, device=dev)
    if words.shape != (c, 2):
        raise ValueError(f"key words must be [C, 2] = [{c}, 2] (got "
                         f"{tuple(words.shape)})")

    def per_chain(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).expand(c).contiguous()

    return words, state, per_chain(lam), per_chain(gamma)


def gillespie_step_reference(key_words, state, lam, gamma, n_total,
                             t_end: float = 1.0, unroll: int = 8):
    """The plain PyTorch day-step on any device (the kernel's twin):
    ``state [C, N, 2]`` one unit of time ahead; ``key_words [C, 2]``,
    ``lam``/``gamma`` scalars or ``[C]``."""
    words, state, lam, gam = _prepare(key_words, state, lam, gamma)
    inv_nt = float(np.float32(1.0 / float(n_total)))
    keys = lane_keys(words, state.shape[1])
    ctr = torch.zeros((state.shape[0], 1), dtype=torch.int64,
                      device=state.device)
    s, i, _ = gillespie_day(keys, ctr, state[..., 0], state[..., 1],
                            lam[:, None] * inv_nt, gam[:, None],
                            float(t_end), int(unroll))
    return torch.stack([s, i], dim=-1)


def gillespie_step(key_words, state, lam, gamma, n_total,
                   t_end: float = 1.0, unroll: int = 8):
    """Exact SIR advance over ``[0, t_end]`` for ``C`` chains (module
    docstring): ``state [C, N, 2]`` float32, ``key_words [C, 2]`` (int64
    holding each chain's uint32 key words), ``lam``/``gamma`` scalars or
    ``[C]``. Returns the new ``[C, N, 2]`` state."""
    words, state, lam, gam = _prepare(key_words, state, lam, gamma)
    if state.device.type == "cpu":
        return gillespie_step_reference(words, state, lam, gam, n_total,
                                        t_end, unroll)
    return _build.launch_gillespie(
        words, state, lam, gam, inv_nt=float(np.float32(1.0 / n_total)),
        t_end=float(t_end), unroll=int(unroll))
