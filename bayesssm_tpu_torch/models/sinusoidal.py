"""The README's sinusoidal AR(1) state-space model (port of
``bayesssm_tpu/models/sinusoidal.py``).

    x_0 ~ N(0, 1)
    x_t = phi * x_{t-1} + sin(x_{t-1}) + N(0, sigma_x^2)
    y_t = x_t + N(0, sigma_y^2)

Priors: phi ~ Unif(0, 1), sigma_x ~ Exp(1), sigma_y ~ Exp(1).

Two filters run it: the generic engine (``filters/core.py``) with the model
functions of :func:`sinusoidal_model`, whose weight step is the fused
kernel K3 on the card, and the whole-sweep op behind
:func:`sinusoidal_sweep_pf_impl`, whose CUDA kernel is K1 with the
``SinusoidalModel`` functor (``csrc/models.cuh``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bayesssm_tpu_torch.models.distributions import (
    exp_logpdf,
    norm_logpdf,
    unif_logpdf,
)
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.sweep_builder import (
    KernelModel,
    build_sweep_op,
    build_sweep_pf_impl,
)

__all__ = ["sinusoidal_model", "sinusoidal_sweep_pf_impl",
           "simulate_sinusoidal"]

_HALF_LOG_2PI = float(np.float32(0.5 * np.log(2.0 * np.pi)))


def sinusoidal_model():
    """``(model_fns, log_priors, param_transform)`` with the JAX function's
    signature and return value; theta = (phi, sigma_x, sigma_y).

    ``model_fns`` is ``(init_fn, transition_fn, log_likelihood_fn)`` written
    for the engine: particles ``[C, N]``, parameters ``[C]``, and normals
    drawn by ``ops/threefry.py`` from each chain's key, as
    ``jax.random.normal`` draws them. The transform is the JAX package's:
    phi on the identity, both scales on the log.
    """

    def init_fn(key, num_particles):
        return threefry.normal(key, (num_particles,))

    def transition_fn(key, particles, phi, sigma_x):
        noise = threefry.normal(key, particles.shape[1:])
        return (phi[:, None] * particles + torch.sin(particles)
                + sigma_x[:, None] * noise)

    def log_likelihood_fn(y, particles, sigma_y):
        return norm_logpdf(y, mean=particles, sd=sigma_y[:, None])

    log_priors = {
        "phi": lambda phi: unif_logpdf(phi, 0.0, 1.0),
        "sigma_x": lambda s: exp_logpdf(s, 1.0),
        "sigma_y": lambda s: exp_logpdf(s, 1.0),
    }
    param_transform = {"phi": "identity", "sigma_x": "log", "sigma_y": "log"}
    return ((init_fn, transition_fn, log_likelihood_fn), log_priors,
            param_transform)


def _sweep_init(rng, theta):
    return (rng.normal(),)


def _sweep_transition(rng, cols, theta, t):
    phi, sigma_x, _ = theta
    x = cols[0]
    return (phi * x + torch.sin(x) + sigma_x * rng.normal(),)


def _sweep_log_weight(cols, theta, y_t):
    _, _, sigma_y = theta
    r = (y_t - cols[0]) / sigma_y
    return -0.5 * r * r - torch.log(sigma_y) - _HALF_LOG_2PI


_KERNEL = KernelModel("bssm_sweep_sinusoidal", ())


@functools.lru_cache(maxsize=None)
def _sinusoidal_op(resample_fn: str = "stratified",
                   resample_algorithm: str = "SISAR", obs_gaps=None):
    """The whole-sweep op of the README model with theta ``[C, 3]`` =
    (phi, sigma_x, sigma_y): the plain callbacks below and the
    ``SinusoidalModel`` functor of K1."""
    return build_sweep_op(
        1, _sweep_init, _sweep_transition, _sweep_log_weight, 3,
        resample_fn=resample_fn,
        always_resample=resample_algorithm == "SISR",
        never_resample=resample_algorithm == "SIS", obs_gaps=obs_gaps,
        kernel=_KERNEL,
    )


def sinusoidal_sweep_pf_impl(interpret: bool = False):
    """PMMH ``pf_impl`` factory of the whole-sweep op for the README model:
    one state column, Box-Muller normals from the sweep's counter stream,
    Gaussian log-weights; BPF, SIS/SISR/SISAR, stratified or systematic,
    ``obs_times`` as a gap loop. On CUDA tensors the sweep is K1 with the
    ``SinusoidalModel`` functor.

    ``interpret`` is accepted and ignored: the port picks the
    implementation by device. Usage: ``pmmh(...,
    pf_impl=sinusoidal_sweep_pf_impl())``.
    """
    del interpret
    return build_sweep_pf_impl(
        1, _sweep_init, _sweep_transition, _sweep_log_weight,
        ("phi", "sigma_x", "sigma_y"), kernel=_KERNEL,
    )


def simulate_sinusoidal(seed=1405, t_val=20, phi=0.8, sigma_x=1.0,
                        sigma_y=0.5):
    """``(x [T+1], y [T])``, the same draws as the JAX package's
    ``simulate_sinusoidal`` for the same seed."""
    rng = np.random.default_rng(seed)
    x = np.zeros(t_val + 1)
    y = np.zeros(t_val)
    x[0] = rng.normal()
    for t in range(t_val):
        x[t + 1] = phi * x[t] + np.sin(x[t]) + sigma_x * rng.normal()
        y[t] = x[t + 1] + sigma_y * rng.normal()
    return x, y
