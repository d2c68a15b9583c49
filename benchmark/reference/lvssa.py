"""Plain reference of the Lotka-Volterra predator-prey model under exact
Gillespie simulation (configuration family ``lvssa``; Wilkinson's
``smfsb`` ``StepGillespie(LV)`` / ``stepLVc``, Golightly & Wilkinson 2011).

    reactions  prey birth X1 -> 2 X1, predation X1 + X2 -> 2 X2,
               predator death X2 -> 0
    hazards    h = (c1 x1, c2 x1 x2, c3 x2), h0 = (h1 + h2) + h3
    an event   the time left r becomes r + log1p(-u0) / h0; if r > 0, the
               reaction is a birth when u1 h0 < h1, a predation when
               h1 <= u1 h0 < h1 + h2, a death otherwise
    interval   events fire until r <= 0 or h0 = 0, from r = obs_interval
    start      each species by counting unit-rate arrivals, at times
               s -= log1p(-u), while they fall below its mean (Poisson)
    observed   y = x + N(0, obs_sd^2 I) at the end of every interval

Priors ``c1 ~ Exp(1)``, ``c2 ~ Exp(100)``, ``c3 ~ Exp(1)``
(``reference/lv.py``'s). The whole sweep runs each loop for every lane of
a chain while any lane of the chain still runs, at most ``max_iters``
iterations an interval; iteration k draws its uniforms at the chain's
counter, which moves only on the iterations in which the chain runs, and
a lane that has stopped keeps its state, as ``smc.py::gillespie_day``
runs the SIR day. Its expressions are the user's callbacks', op for op.
The tally counts the lanes' own iterations, the start's arrivals
included.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import lowbias
from benchmark.reference.lv import PARAMS, log_priors  # noqa: F401

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def simulate(cfg: dict) -> np.ndarray:
    """The configuration's observations ``[T, 2]`` from its data seed:
    the exact jump process from exactly ``x0_mean`` at theta, in float64,
    each event's waiting time ``Exp(h0)`` and its reaction drawn by
    NumPy's ``default_rng``, then the noise normals ``[T, 2]``; observed
    every ``obs_interval`` time units."""
    rng = np.random.default_rng(cfg["data_seed"])
    c1, c2, c3 = (cfg["theta"][q] for q in PARAMS)
    x1, x2 = (float(m) for m in cfg["x0_mean"])
    t_val = cfg["t_max"]
    xs = np.zeros((t_val, 2))
    for k in range(t_val):
        r = float(cfg["obs_interval"])
        while True:
            h1, h2, h3 = c1 * x1, c2 * x1 * x2, c3 * x2
            h0 = h1 + h2 + h3
            if h0 <= 0.0:
                break
            r -= rng.exponential(1.0 / h0)
            if r <= 0.0:
                break
            v = rng.uniform() * h0
            if v < h1:
                x1 += 1.0
            elif v < h1 + h2:
                x1, x2 = x1 - 1.0, x2 + 1.0
            else:
                x2 -= 1.0
        xs[k] = x1, x2
    return xs + cfg["obs_sd"] * rng.normal(size=(t_val, 2))


# Iterations between the host's looks at whether any lane still runs: an
# iteration in which none does changes nothing, so looking less often
# only saves the waits.
LOOK_EVERY = 16


def _uniforms(keys, ctr, draws: int):
    """``[draws, C, N]`` uniforms at counters ``ctr .. ctr + draws - 1``,
    the blocks of ``lowbias.uniform_blocks`` hashed in one pass."""
    k = torch.arange(draws, dtype=torch.int64, device=keys.device)
    ctrs = (ctr[None] + k[:, None, None]) & lowbias.MASK32
    bits = lowbias.hash32(keys[None] ^ lowbias.mul32(ctrs, lowbias.STEP_MUL))
    return (bits >> 8).to(torch.float32) * lowbias.INV24


def _event_loop(rng, running, step, state, draws: int, max_iters: int):
    """Every lane of a chain steps while any lane of it runs, at most
    ``max_iters`` times: ``(state, own iterations [C, N])``."""
    ctr = rng.ctr
    own = torch.zeros(state[0].shape, dtype=torch.int64,
                      device=state[0].device)
    for i in range(max_iters):
        live = running(state)
        go = live.any(dim=1, keepdim=True)
        if i % LOOK_EVERY == 0 and not bool(go.any()):
            break
        u = _uniforms(rng.keys, ctr, draws).to(rng.dt)
        new = step(u, state)
        state = tuple(torch.where(live, a, b) for a, b in zip(new, state))
        ctr = ctr + draws * go
        own += live
    rng.ctr = ctr
    return state, own


class Model:
    """The LV-SSA callbacks of the whole sweep, one interval a
    transition."""

    params = PARAMS
    state_cols = 2

    def __init__(self, cfg: dict):
        self.delta = float(cfg["obs_interval"])
        self.means = tuple(float(m) for m in cfg["x0_mean"])
        self.max_iters = int(cfg["max_iters"])
        self.obs_sd = float(cfg["obs_sd"])
        self.norm2 = -2.0 * (HALF_LOG_2PI + math.log(self.obs_sd))
        self.start_iters = None   # the start's arrivals, tallied at t = 0
        self.most_iters = 0       # the most iterations a chain has run

    def _note(self, own):
        self.most_iters = max(self.most_iters, int(own.max()))

    def sweep_obs(self, y, device, dt):
        return torch.as_tensor(np.asarray(y), dtype=torch.float32).to(
            device=device, dtype=dt)

    def _poisson(self, rng, mean, like):
        def running(state):
            return state[1] < mean

        def step(u, state):
            n, s = state
            s = s - torch.log1p(-u[0])
            return torch.where(s < mean, n + 1.0, n), s

        zero = torch.zeros_like(like)
        (n, _), own = _event_loop(rng, running, step, (zero, zero), 1,
                                  self.max_iters)
        self._note(own)
        return n, own

    def sweep_init(self, rng, th):
        x1, own1 = self._poisson(rng, self.means[0], th[0])
        x2, own2 = self._poisson(rng, self.means[1], th[0])
        self.start_iters = own1 + own2
        return x1, x2

    def sweep_transition(self, rng, cols, th, t, tally):
        c1, c2, c3 = th

        def rates(x1, x2):
            h1 = c1 * x1
            h12 = h1 + c2 * x1 * x2
            return h1, h12, h12 + c3 * x2

        def running(state):
            x1, x2, r = state
            return (r > 0.0) & (rates(x1, x2)[2] > 0.0)

        def step(u, state):
            x1, x2, r = state
            h1, h12, h0 = rates(x1, x2)
            r = r + torch.log1p(-u[0]) / h0
            fire = r > 0.0
            v = u[1] * h0
            birth = fire & (v < h1)
            predation = fire & (v >= h1) & (v < h12)
            death = fire & (v >= h12)
            x1 = torch.where(birth, x1 + 1.0,
                             torch.where(predation, x1 - 1.0, x1))
            x2 = torch.where(predation, x2 + 1.0,
                             torch.where(death, x2 - 1.0, x2))
            return x1, x2, r

        x1, x2 = cols
        (x1, x2, _), own = _event_loop(
            rng, running, step, (x1, x2, torch.full_like(x1, self.delta)), 2,
            self.max_iters)
        self._note(own)
        if tally is not None:
            if t == 0 and self.start_iters is not None:
                tally.add(self.start_iters, 0)
            tally.add(own, x1.shape[0])
        return x1, x2

    def sweep_log_weight(self, cols, th, y_t):
        z1 = (y_t[0] - cols[0]) / self.obs_sd
        z2 = (y_t[1] - cols[1]) / self.obs_sd
        return self.norm2 - 0.5 * (z1 * z1 + z2 * z2)
