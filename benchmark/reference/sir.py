"""Plain reference of the stochastic SIR model (configuration family
``sir``).

Closed population ``n_total``; state (S, I) from ``(n_total -
init_infected, init_infected)``; infection rate ``lam / n_total * S * I``,
removal rate ``gamma * I``, simulated exactly (Gillespie) day by day;
``y_t ~ Poisson(I(t))``. Priors ``lam ~ HalfNormal(1)``, ``gamma ~
HalfNormal(2)``.

Both filters' callbacks are here: the whole sweep draws every day's events
from one lane stream with a per-chain counter; the engine draws each
day's events from the day's key, its counter from 0.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import lowbias, smc

PARAMS = ("lam", "gamma")
UNROLL = 8
_LOG_2PI = float(torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32)))


def simulate(cfg: dict) -> np.ndarray:
    """The configuration's observations ``[T]`` from its data seed: one
    exact epidemic at the generating theta and Poisson counts, drawn by
    NumPy's ``default_rng``."""
    rng = np.random.default_rng(cfg["data_seed"])
    n_total = cfg["n_total"]
    lam, gamma = cfg["theta"]["lam"], cfg["theta"]["gamma"]
    s = float(n_total - cfg["init_infected"])
    i = float(cfg["init_infected"])
    infected = np.zeros(cfg["t_max"])
    for t in range(cfg["t_max"]):
        tt = 0.0
        while i > 0:
            rate_inf = lam / n_total * s * i
            rate_tot = rate_inf + gamma * i
            if rate_tot <= 0:
                break
            dt = rng.exponential(1.0 / rate_tot)
            if tt + dt > 1.0:
                break
            tt += dt
            if rng.uniform() < rate_inf / rate_tot:
                s -= 1.0
                i += 1.0
            else:
                i -= 1.0
        infected[t] = i
    return rng.poisson(infected).astype(np.float64)


def _halfnorm(x, sigma: float):
    two = torch.full((), 2.0, dtype=x.dtype, device=x.device)
    sig = torch.full((), sigma, dtype=x.dtype, device=x.device)
    return torch.where(
        x >= 0,
        torch.log(two) - 0.5 * _LOG_2PI - torch.log(sig)
        - 0.5 * (x / sig) ** 2,
        torch.full((), -math.inf, dtype=x.dtype, device=x.device))


def log_priors():
    return [lambda v: _halfnorm(v, 1.0), lambda v: _halfnorm(v, 2.0)]


def _pois(k, rate):
    """log Poisson(k; rate), all mass on 0 when the rate is 0."""
    one = torch.full((), 1.0, dtype=rate.dtype, device=rate.device)
    safe = torch.where(rate > 0, rate, one)
    out = k * torch.log(safe) - rate - torch.lgamma(k + 1.0)
    zero = torch.full((), 0.0, dtype=rate.dtype, device=rate.device)
    ninf = torch.full((), -math.inf, dtype=rate.dtype, device=rate.device)
    return torch.where(rate > 0, out, torch.where(k == 0, zero, ninf))


class Model:
    """The SIR callbacks of both filters for one configuration."""

    params = PARAMS
    state_cols = 2

    def __init__(self, cfg: dict):
        self.n_total = int(cfg["n_total"])
        self.inv_nt = float(np.float32(1.0 / float(self.n_total)))
        self.s0 = float(self.n_total - cfg["init_infected"])
        self.i0 = float(cfg["init_infected"])

    def sweep_obs(self, y, device, dt):
        """``[T, 2]``: the counts and their ``lgamma(y + 1)``, taken in
        float32 on the host."""
        ys = torch.as_tensor(np.asarray(y), dtype=torch.float32)
        return torch.stack([ys, torch.lgamma(ys + 1.0)], dim=1).to(
            device=device, dtype=dt)

    def engine_obs(self, y, device, dt):
        return torch.as_tensor(np.asarray(y), dtype=dt,
                               device=device)[:, None]

    # --- the whole sweep ---
    def sweep_init(self, rng, th):
        return torch.full_like(th[0], self.s0), torch.full_like(th[0], self.i0)

    def sweep_transition(self, rng, cols, th, t, tally):
        s, i, ctr = smc.gillespie_day(rng.keys, rng.ctr, cols[0], cols[1],
                                      th[0] * self.inv_nt, th[1], 1.0,
                                      UNROLL, rng.dt, tally)
        rng.ctr = ctr
        return s, i

    def sweep_log_weight(self, cols, th, y_t):
        y_v, lgy = y_t
        i = cols[1]
        lw = y_v * torch.log(torch.where(i > 0.0, i, 1.0)) - i - lgy
        return torch.where(i > 0.0, lw, torch.where(
            y_v == 0.0, torch.zeros_like(lw), torch.full_like(lw, smc.NEG)))

    # --- the per-day engine ---
    def engine_init(self, key, n, th, dt):
        c = key.shape[0]
        return torch.stack([
            torch.full((c, n), self.s0, dtype=dt, device=key.device),
            torch.full((c, n), self.i0, dtype=dt, device=key.device),
        ], dim=-1)

    def engine_transition(self, key, particles, th, tally):
        keys = lowbias.lane_keys(key, particles.shape[1])
        ctr = torch.zeros((particles.shape[0], 1), dtype=torch.int64,
                          device=particles.device)
        s, i, _ = smc.gillespie_day(
            keys, ctr, particles[..., 0], particles[..., 1],
            th[0][:, None] * self.inv_nt, th[1][:, None], 1.0, UNROLL,
            particles.dtype, tally)
        return torch.stack([s, i], dim=-1)

    def engine_log_weight(self, y, particles, th):
        return _pois(y, particles[..., 1])
