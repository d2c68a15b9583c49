"""Linear-Gaussian state-space model with an exact Kalman value (port of
``bayesssm_tpu/models/lgss.py``).

    x_0 ~ N(0, p0^2), x_t = a x_{t-1} + N(0, sigma_x^2),
    y_t = c x_t + N(0, sigma_y^2).
"""

from __future__ import annotations

import numpy as np

from bayesssm_tpu_torch.models.distributions import exp_logpdf, unif_logpdf

__all__ = ["lgss_model", "simulate_lgss"]


def lgss_model():
    """``(log_priors, param_transform)``; theta = (a, sigma_x, sigma_y)."""
    log_priors = {
        "a": lambda v: unif_logpdf(v, -1.0, 1.0),
        "sigma_x": lambda v: exp_logpdf(v, 1.0),
        "sigma_y": lambda v: exp_logpdf(v, 1.0),
    }
    param_transform = {"a": "identity", "sigma_x": "log", "sigma_y": "log"}
    return log_priors, param_transform


def simulate_lgss(seed, t_val=25, a=0.9, c=1.0, sigma_x=0.6, sigma_y=0.4,
                  p0=1.0):
    """``(x [T+1], y [T])``, the same draws as the JAX package's
    ``simulate_lgss`` for the same seed."""
    rng = np.random.default_rng(seed)
    x = np.zeros(t_val + 1)
    y = np.zeros(t_val)
    x[0] = p0 * rng.normal()
    for t in range(t_val):
        x[t + 1] = a * x[t] + sigma_x * rng.normal()
        y[t] = c * x[t + 1] + sigma_y * rng.normal()
    return x, y
