"""The system under test's Lotka-Volterra filter under the chemical
Langevin equation, built as a user builds it: three ``torch`` callbacks
given to the public ``build_sweep_pf_impl`` factory with two state and two
observation columns, and the observation times in Euler steps, so that on
the card they run as the functor generated from them inside K1's gap
loop (``obs_every`` transitions before each weight stage). Bootstrap
filter, SISAR, stratified, as ``pmmh()`` builds it with this ``pf_impl``.

The model (``reference/lv.py`` has its equations): one Euler-Maruyama CLE
step of ``DT`` a transition, hazards from the state, which every step
leaves non-negative, a guarded division by ``l11``, ``l22``'s argument
and the new state clamped at 0; Gaussian noise of sd ``OBS_SD`` on both
species.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PARAMS = ("c1", "c2", "c3")
DT = 0.01
SQRT_DT = math.sqrt(DT)
X0 = (50.0, 100.0)
SD0 = tuple(math.sqrt(m) for m in X0)
OBS_SD = 10.0
TINY = 1e-30
NORM2 = -2.0 * (0.5 * math.log(2.0 * math.pi) + math.log(OBS_SD))


def lv_init(rng, theta):
    x1 = X0[0] + SD0[0] * rng.normal()
    x2 = X0[1] + SD0[1] * rng.normal()
    return torch.clamp(x1, min=0.0), torch.clamp(x2, min=0.0)


def lv_transition(rng, cols, theta, t):
    c1, c2, c3 = theta
    x1, x2 = cols
    h1 = c1 * x1
    h2 = c2 * x1 * x2
    h3 = c3 * x2
    l11 = torch.sqrt(h1 + h2)
    l21 = -h2 / torch.clamp(l11, min=TINY)
    l22 = torch.sqrt(torch.clamp(h2 + h3 - l21 * l21, min=0.0))
    z1 = rng.normal()
    z2 = rng.normal()
    x1 = x1 + (h1 - h2) * DT + SQRT_DT * (l11 * z1)
    x2 = x2 + (h2 - h3) * DT + SQRT_DT * (l21 * z1 + l22 * z2)
    return torch.clamp(x1, min=0.0), torch.clamp(x2, min=0.0)


def lv_log_weight(cols, theta, y_t):
    z1 = (y_t[0] - cols[0]) / OBS_SD
    z2 = (y_t[1] - cols[1]) / OBS_SD
    return NORM2 - 0.5 * (z1 * z1 + z2 * z2)


def lv_pf_impl():
    """The ``pf_impl`` factory of the callbacks above."""
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    return build_sweep_pf_impl(
        num_state_cols=2,
        init_fn=lv_init,
        transition_fn=lv_transition,
        log_weight_fn=lv_log_weight,
        param_names=PARAMS,
        num_obs_cols=2,
    )


def obs_times(cfg: dict) -> np.ndarray:
    """The observations' times in Euler steps: ``obs_every, 2 obs_every,
    ..., t_max obs_every``."""
    return cfg["obs_every"] * np.arange(1, cfg["t_max"] + 1)


def build(cfg: dict, path: str, y, particles: int, lanes: int):
    """``(pf, prior_fns)``: ``pf(seed_words [C, 2], theta [C, 3], n)``
    and the priors ``c1 ~ Exp(1)``, ``c2 ~ Exp(100)``, ``c3 ~ Exp(1)`` in
    ``PARAMS`` order."""
    from bayesssm_tpu_torch.models.distributions import exp_logpdf

    if path != "sweep":
        raise ValueError(f"unknown LV filter path {path!r}")
    stated = (cfg["dt"], tuple(cfg["x0"]), cfg["obs_sd"])
    if stated != (DT, X0, OBS_SD):
        raise ValueError(f"the LV callbacks take dt, x0, obs_sd = "
                         f"{(DT, X0, OBS_SD)}; the configuration states "
                         f"{stated}")
    pf = lv_pf_impl()(y, particles, list(PARAMS), None, obs_times(cfg),
                      "BPF", "SISAR", "stratified", False,
                      max_particles=lanes)
    priors = [lambda c: exp_logpdf(c, 1.0), lambda c: exp_logpdf(c, 100.0),
              lambda c: exp_logpdf(c, 1.0)]
    return pf, priors
