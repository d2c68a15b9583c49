"""Stochastic-volatility model (port of
``bayesssm_tpu/models/stochastic_volatility.py``).

    x_1 ~ N(mu, sigma^2 / (1 - phi^2))            (stationary start)
    x_t = mu + phi * (x_{t-1} - mu) + sigma * eta_t
    y_t ~ N(0, exp(x_t))

Priors: phi ~ Beta(9, 1), sigma ~ Exp(2), mu ~ N(0, 2). Transforms: phi
``logit`` (proposed in logit space, quirk Q1 of ``pmmh/transforms.py``),
sigma ``log``, mu ``identity``. The JAX package ships no whole-sweep
kernel for it: the engine runs it (its weight step is K3 on the card), and
so does the whole-sweep kernel with the callbacks a user writes for it
(``examples/torch_custom_sweep_kernel.py``, a functor generated from
them on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from bayesssm_tpu_torch.models.distributions import (
    beta_logpdf,
    exp_logpdf,
    norm_logpdf,
)
from bayesssm_tpu_torch.ops import threefry

__all__ = ["sv_model", "simulate_sv"]


def sv_model():
    """``(model_fns, log_priors, param_transform)`` with the JAX function's
    signature and return value; ``model_fns`` is ``(init_fn,
    transition_fn, log_likelihood_fn)`` written for the engine (particles
    ``[C, N]``, parameters ``[C]``, threefry normals from each chain's
    key)."""

    def init_fn(key, num_particles, phi, sigma, mu):
        sd0 = sigma / torch.sqrt(1.0 - phi * phi)
        return (mu[:, None]
                + sd0[:, None] * threefry.normal(key, (num_particles,)))

    def transition_fn(key, particles, phi, sigma, mu):
        noise = threefry.normal(key, particles.shape[1:])
        mu = mu[:, None]
        return mu + phi[:, None] * (particles - mu) + sigma[:, None] * noise

    def log_likelihood_fn(y, particles):
        # y_t | x_t ~ N(0, exp(x_t)): sd = exp(x_t / 2).
        return norm_logpdf(y, mean=0.0, sd=torch.exp(0.5 * particles))

    log_priors = {
        "phi": lambda p: beta_logpdf(p, 9.0, 1.0),
        "sigma": lambda s: exp_logpdf(s, 2.0),
        "mu": lambda m: norm_logpdf(m, 0.0, 2.0),
    }
    param_transform = {"phi": "logit", "sigma": "log", "mu": "identity"}
    return ((init_fn, transition_fn, log_likelihood_fn), log_priors,
            param_transform)


def simulate_sv(seed=1405, t_val=50, phi=0.95, sigma=0.3, mu=-1.0):
    """``(x [T], y [T])``, the same draws as the JAX package's
    ``simulate_sv`` for the same seed."""
    rng = np.random.default_rng(seed)
    x = np.zeros(t_val)
    y = np.zeros(t_val)
    x[0] = mu + sigma / np.sqrt(1.0 - phi * phi) * rng.normal()
    y[0] = np.exp(0.5 * x[0]) * rng.normal()
    for t in range(1, t_val):
        x[t] = mu + phi * (x[t - 1] - mu) + sigma * rng.normal()
        y[t] = np.exp(0.5 * x[t]) * rng.normal()
    return x, y
