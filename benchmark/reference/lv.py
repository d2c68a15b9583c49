"""Plain reference of the Lotka-Volterra predator-prey model under the
chemical Langevin equation (configuration family ``lv``; Golightly &
Wilkinson 2011, Wilkinson's ``smfsb`` ``LV`` and ``StepCLE``).

    hazards    h = (c1 x1, c2 x1 x2, c3 x2)
    drift      mu = (h1 - h2, h2 - h3)
    diffusion  L = chol([[h1 + h2, -h2], [-h2, h2 + h3]]):
               l11 = sqrt(h1 + h2), l21 = -h2 / l11,
               l22 = sqrt(h2 + h3 - l21^2)
    step       x' = max(x + mu dt + sqrt(dt) L z, 0), z two normals
    start      x_i ~ N(m_i, m_i) around the marking m, clamped at 0
    observed   y = x + N(0, obs_sd^2 I) after every ``obs_every`` steps

The division by l11 is guarded (by ``max(l11, 1e-30)``) and l22's
argument is clamped at 0, so that no NaN or infinity is formed. Priors
``c1 ~ Exp(1)``, ``c2 ~ Exp(100)``, ``c3 ~ Exp(1)``. The whole sweep
draws each normal from two counter uniforms of the lane stream by
Box-Muller, the counter moving by two; its callbacks are the user's,
written op for op as the program's are, and its transition makes the
day's ``gaps[t]`` Euler steps itself, so that ``reference/smc.py`` runs it
as it runs a model of one transition a day.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import lowbias

PARAMS = ("c1", "c2", "c3")
RATES = (1.0, 100.0, 1.0)    # the exponential priors' rates, in PARAMS order
TINY = 1e-30                 # the guard of the division by l11
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _step_np(x, c, dt, z):
    """One clamped Euler-Maruyama CLE step in float64."""
    x1, x2 = x
    h1, h2, h3 = c[0] * x1, c[1] * x1 * x2, c[2] * x2
    l11 = math.sqrt(h1 + h2)
    l21 = -h2 / max(l11, TINY)
    l22 = math.sqrt(max(h2 + h3 - l21 * l21, 0.0))
    sdt = math.sqrt(dt)
    return np.maximum([x1 + (h1 - h2) * dt + sdt * l11 * z[0],
                       x2 + (h2 - h3) * dt + sdt * (l21 * z[0] + l22 * z[1])],
                      0.0)


def simulate(cfg: dict) -> np.ndarray:
    """The configuration's observations ``[T, 2]`` from its data seed: the
    clamped Euler CLE from exactly the marking ``x0`` at theta, observed
    with Gaussian noise after steps ``obs_every, 2 obs_every, ...``. The
    step normals ``[T * obs_every, 2]`` and then the noise normals ``[T,
    2]`` are drawn by NumPy's ``default_rng``."""
    rng = np.random.default_rng(cfg["data_seed"])
    c = [cfg["theta"][q] for q in PARAMS]
    t_val, every = cfg["t_max"], cfg["obs_every"]
    z = rng.normal(size=(t_val * every, 2))
    noise = rng.normal(size=(t_val, 2))
    x = np.asarray(cfg["x0"], dtype=np.float64)
    y = np.zeros((t_val, 2))
    for k in range(t_val):
        for s in range(every):
            x = _step_np(x, c, cfg["dt"], z[k * every + s])
        y[k] = x + cfg["obs_sd"] * noise[k]
    return y


def _full(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


def log_priors():
    def expo(rate):
        def log_density(x):
            r = _full(rate, x)
            return torch.where(x >= 0, torch.log(r) - r * x,
                               _full(-math.inf, x))
        return log_density

    return [expo(rate) for rate in RATES]


def _normal(rng):
    """A standard normal from the lane stream's next two uniforms, in
    float32 and cast."""
    u = lowbias.uniform_blocks(rng.keys, rng.ctr, 2)
    rng.ctr = rng.ctr + 2
    return lowbias.box_muller(u[0], u[1]).to(rng.dt)


class Model:
    """The LV-CLE callbacks of the whole sweep. ``gaps`` (one Euler-step
    count a weight stage) defaults to the configuration's ``obs_every``
    at each of its ``t_max`` observations."""

    params = PARAMS
    state_cols = 2

    def __init__(self, cfg: dict, gaps=None):
        self.gaps = (tuple(int(g) for g in gaps) if gaps is not None
                     else (int(cfg["obs_every"]),) * int(cfg["t_max"]))
        self.dt = float(cfg["dt"])
        self.sqrt_dt = math.sqrt(self.dt)
        self.x0 = tuple(float(m) for m in cfg["x0"])
        self.sd0 = tuple(math.sqrt(m) for m in self.x0)
        self.obs_sd = float(cfg["obs_sd"])
        self.norm2 = -2.0 * (HALF_LOG_2PI + math.log(self.obs_sd))

    def sweep_obs(self, y, device, dt):
        return torch.as_tensor(np.asarray(y), dtype=torch.float32).to(
            device=device, dtype=dt)

    def sweep_init(self, rng, th):
        x1 = self.x0[0] + self.sd0[0] * _normal(rng)
        x2 = self.x0[1] + self.sd0[1] * _normal(rng)
        return torch.clamp(x1, min=0.0), torch.clamp(x2, min=0.0)

    def _euler(self, rng, x1, x2, th):
        c1, c2, c3 = th
        h1 = c1 * x1
        h2 = c2 * x1 * x2
        h3 = c3 * x2
        l11 = torch.sqrt(h1 + h2)
        l21 = -h2 / torch.clamp(l11, min=TINY)
        l22 = torch.sqrt(torch.clamp(h2 + h3 - l21 * l21, min=0.0))
        z1 = _normal(rng)
        z2 = _normal(rng)
        x1 = x1 + (h1 - h2) * self.dt + self.sqrt_dt * (l11 * z1)
        x2 = x2 + (h2 - h3) * self.dt + self.sqrt_dt * (l21 * z1 + l22 * z2)
        return torch.clamp(x1, min=0.0), torch.clamp(x2, min=0.0)

    def sweep_transition(self, rng, cols, th, t, tally):
        x1, x2 = cols
        for _ in range(self.gaps[t]):
            x1, x2 = self._euler(rng, x1, x2, th)
        return x1, x2

    def sweep_log_weight(self, cols, th, y_t):
        z1 = (y_t[0] - cols[0]) / self.obs_sd
        z2 = (y_t[1] - cols[1]) / self.obs_sd
        return self.norm2 - 0.5 * (z1 * z1 + z2 * z2)
