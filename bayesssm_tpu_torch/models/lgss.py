"""Linear-Gaussian state-space model with an exact Kalman value (port of
``bayesssm_tpu/models/lgss.py``).

    x_0 ~ N(0, p0^2), x_t = a x_{t-1} + N(0, sigma_x^2),
    y_t = c x_t + N(0, sigma_y^2),

and its vector-observation form (:func:`lgss_mv_model`), where
``y_t = c_vec x_t + N(0, diag(sigma_y^2))`` has ``d_y`` components.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesssm_tpu_torch.models.distributions import (
    exp_logpdf,
    norm_logpdf,
    unif_logpdf,
)
from bayesssm_tpu_torch.ops import threefry

__all__ = ["lgss_model", "simulate_lgss", "lgss_mv_model",
           "simulate_lgss_mv"]


def lgss_model(c: float = 1.0, p0: float = 1.0):
    """``(model_fns, log_priors, param_transform)`` with the JAX function's
    signature and return value; theta = (a, sigma_x, sigma_y).

    ``model_fns`` is ``(init_fn, transition_fn, log_likelihood_fn)`` written
    for the engine (``filters/core.py``): particles ``[C, N]``, parameters
    ``[C]``, and normals drawn by ``ops/threefry.py`` from each chain's key,
    as ``jax.random.normal`` draws them. The log-marginal likelihood has an
    exact Kalman value (``utils/kalman.py``), the engine's anchor.
    """

    def init_fn(key, num_particles):
        return p0 * threefry.normal(key, (num_particles,))

    def transition_fn(key, particles, a, sigma_x):
        return (a[:, None] * particles
                + sigma_x[:, None] * threefry.normal(key, particles.shape[1:]))

    def log_likelihood_fn(y, particles, sigma_y):
        return norm_logpdf(y, mean=c * particles, sd=sigma_y[:, None])

    log_priors = {
        "a": lambda v: unif_logpdf(v, -1.0, 1.0),
        "sigma_x": lambda v: exp_logpdf(v, 1.0),
        "sigma_y": lambda v: exp_logpdf(v, 1.0),
    }
    param_transform = {"a": "identity", "sigma_x": "log", "sigma_y": "log"}
    return ((init_fn, transition_fn, log_likelihood_fn), log_priors,
            param_transform)


def lgss_mv_model(c_vec=(1.0, 0.5), p0: float = 1.0):
    """Scalar-state LGSS with a vector observation, with the JAX function's
    signature and return value: the engine hands the weight function each
    day's ``y_t`` row ``[d_y]``, and the log-likelihood is the sum of the
    ``d_y`` independent Gaussian components with one shared ``sigma_y``
    (so the parameters are those of :func:`lgss_model`). The exact value
    is ``utils/kalman.py::kalman_loglik_mv``."""
    cv = np.asarray(c_vec, dtype=np.float32)

    def init_fn(key, num_particles):
        return p0 * threefry.normal(key, (num_particles,))

    def transition_fn(key, particles, a, sigma_x):
        return (a[:, None] * particles
                + sigma_x[:, None] * threefry.normal(key, particles.shape[1:]))

    def log_likelihood_fn(y, particles, sigma_y):
        # y [d_y], particles [C, N] -> [C, N]
        mean = torch.as_tensor(cv, device=particles.device) * particles[
            ..., None]
        return norm_logpdf(y[None, None, :], mean=mean,
                           sd=sigma_y[:, None, None]).sum(dim=-1)

    log_priors = {
        "a": lambda v: unif_logpdf(v, -1.0, 1.0),
        "sigma_x": lambda v: exp_logpdf(v, 1.0),
        "sigma_y": lambda v: exp_logpdf(v, 1.0),
    }
    param_transform = {"a": "identity", "sigma_x": "log", "sigma_y": "log"}
    return ((init_fn, transition_fn, log_likelihood_fn), log_priors,
            param_transform)


def simulate_lgss_mv(seed, t_val=25, a=0.9, c_vec=(1.0, 0.5), sigma_x=0.6,
                     sigma_y=0.4, p0=1.0):
    """``(x [T+1], y [T, d_y])``, the same draws as the JAX package's
    ``simulate_lgss_mv`` for the same seed."""
    rng = np.random.default_rng(seed)
    cv = np.asarray(c_vec, dtype=np.float64)
    x = np.zeros(t_val + 1)
    y = np.zeros((t_val, cv.shape[0]))
    x[0] = p0 * rng.normal()
    for t in range(t_val):
        x[t + 1] = a * x[t] + sigma_x * rng.normal()
        y[t] = cv * x[t + 1] + sigma_y * rng.normal(size=cv.shape[0])
    return x, y


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
