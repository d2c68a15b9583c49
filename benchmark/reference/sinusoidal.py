"""Plain reference of bayesSSM's README model (configuration family
``sinusoidal``).

    x_0 ~ N(0, 1)
    x_t = phi * x_{t-1} + sin(x_{t-1}) + N(0, sigma_x^2)
    y_t = x_t + N(0, sigma_y^2)

Priors ``phi ~ Unif(0, 1)``, ``sigma_x ~ Exp(1)``, ``sigma_y ~ Exp(1)``.
The engine draws its normals by threefry from each day's key.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import threefry

PARAMS = ("phi", "sigma_x", "sigma_y")
_LOG_2PI = float(torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32)))


def simulate(cfg: dict) -> np.ndarray:
    """The configuration's observations ``[T]`` from its data seed."""
    rng = np.random.default_rng(cfg["data_seed"])
    th = cfg["theta"]
    t_val = cfg["t_max"]
    x = np.zeros(t_val + 1)
    y = np.zeros(t_val)
    x[0] = rng.normal()
    for t in range(t_val):
        x[t + 1] = (th["phi"] * x[t] + np.sin(x[t])
                    + th["sigma_x"] * rng.normal())
        y[t] = x[t + 1] + th["sigma_y"] * rng.normal()
    return y


def _full(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


def log_priors():
    def unif(x):
        return torch.where((x >= _full(0.0, x)) & (x <= _full(1.0, x)),
                           -torch.log(_full(1.0, x) - _full(0.0, x)),
                           _full(-math.inf, x))

    def expo(x):
        rate = _full(1.0, x)
        return torch.where(x >= 0, torch.log(rate) - rate * x,
                           _full(-math.inf, x))

    return [unif, expo, expo]


class Model:
    """The README model's callbacks of the per-day engine."""

    params = PARAMS
    state_cols = 1

    def __init__(self, cfg: dict):
        del cfg

    def engine_obs(self, y, device, dt):
        return torch.as_tensor(np.asarray(y), dtype=dt, device=device)[:, None]

    # --- the per-day engine ---
    def engine_init(self, key, n, th, dt):
        return threefry.normal(key, (n,)).to(dt)

    def engine_transition(self, key, particles, th, tally):
        noise = threefry.normal(key, particles.shape[1:]).to(particles.dtype)
        return (th[0][:, None] * particles + torch.sin(particles)
                + th[1][:, None] * noise)

    def engine_log_weight(self, y, particles, th):
        sd = th[2][:, None]
        z = (y - particles) / sd
        return -0.5 * (_LOG_2PI + z * z) - torch.log(sd)
