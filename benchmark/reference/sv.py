"""Plain reference of the stochastic-volatility model of Kim, Shephard &
Chib (1998) (configuration family ``sv``).

    h_1 ~ N(mu, sigma^2 / (1 - phi^2))            (stationary start)
    h_t = mu + phi * (h_{t-1} - mu) + sigma * eta_t
    y_t ~ N(0, exp(h_t))

Priors ``phi ~ Beta(9, 1)``, ``sigma ~ Exp(2)``, ``mu ~ N(0, 2)``. The
whole sweep draws each normal from two counter uniforms of the lane
stream by Box-Muller, the counter moving by two; its callbacks are the
user's, written op for op as the program's are.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import lowbias

PARAMS = ("phi", "sigma", "mu")
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2PI = float(torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32)))


def simulate(cfg: dict) -> np.ndarray:
    """The configuration's returns ``[T]`` from its data seed: the
    stationary start, then one state normal and one return normal a day,
    drawn by NumPy's ``default_rng``."""
    rng = np.random.default_rng(cfg["data_seed"])
    th = cfg["theta"]
    phi, sigma, mu = th["phi"], th["sigma"], th["mu"]
    t_val = cfg["t_max"]
    x = np.zeros(t_val)
    y = np.zeros(t_val)
    x[0] = mu + sigma / np.sqrt(1.0 - phi * phi) * rng.normal()
    y[0] = np.exp(0.5 * x[0]) * rng.normal()
    for t in range(1, t_val):
        x[t] = mu + phi * (x[t - 1] - mu) + sigma * rng.normal()
        y[t] = np.exp(0.5 * x[t]) * rng.normal()
    return y


def _full(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


def log_priors():
    def beta91(x):
        a, b = _full(9.0, x), _full(1.0, x)
        inside = (x > 0) & (x < 1)
        xs = torch.where(inside, x, _full(0.5, x))
        out = ((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs)
               + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b))
        return torch.where(inside, out, _full(-math.inf, x))

    def expo2(x):
        rate = _full(2.0, x)
        return torch.where(x >= 0, torch.log(rate) - rate * x,
                           _full(-math.inf, x))

    def norm02(x):
        sd = _full(2.0, x)
        z = (x - _full(0.0, x)) / sd
        return -0.5 * (_LOG_2PI + z * z) - torch.log(sd)

    return [beta91, expo2, norm02]


def _normal(rng):
    """A standard normal from the lane stream's next two uniforms, in
    float32 and cast."""
    u = lowbias.uniform_blocks(rng.keys, rng.ctr, 2)
    rng.ctr = rng.ctr + 2
    return lowbias.box_muller(u[0], u[1]).to(rng.dt)


class Model:
    """The SV callbacks of the whole sweep."""

    params = PARAMS
    state_cols = 1

    def __init__(self, cfg: dict):
        del cfg

    def sweep_obs(self, y, device, dt):
        return torch.as_tensor(np.asarray(y), dtype=torch.float32).to(
            device=device, dtype=dt)[:, None]

    def sweep_init(self, rng, th):
        phi, sigma, mu = th
        sd0 = sigma / torch.sqrt(1.0 - phi * phi)
        return (mu + sd0 * _normal(rng),)

    def sweep_transition(self, rng, cols, th, t, tally):
        phi, sigma, mu = th
        return (mu + phi * (cols[0] - mu) + sigma * _normal(rng),)

    def sweep_log_weight(self, cols, th, y_t):
        x = cols[0]
        return -HALF_LOG_2PI - 0.5 * x - 0.5 * y_t * y_t * torch.exp(-x)
