"""Stochastic SIR epidemic model (port of ``bayesssm_tpu/models/sir.py``).

Closed population of ``n_total``; latent state (S, I); infection rate
lam / n_total * S * I, removal rate gamma * I; observation
``Y_t ~ Pois(I(t))`` at integer times. Priors lam ~ HalfNormal(1),
gamma ~ HalfNormal(2), both log-transformed.

The port's SIR filter is the whole-sweep op (``ops/sir_sweep.py``); the
portable per-day model functions wait for the portable filter engine
(ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

from bayesssm_tpu_torch.models.distributions import halfnorm_logpdf

__all__ = ["sir_model", "sir_sweep_pf_impl", "simulate_sir"]


def sir_model():
    """``(log_priors, param_transform)`` of the SIR model."""
    log_priors = {
        "lam": lambda v: halfnorm_logpdf(v, 1.0),
        "gamma": lambda v: halfnorm_logpdf(v, 2.0),
    }
    param_transform = {"lam": "log", "gamma": "log"}
    return log_priors, param_transform


def sir_sweep_pf_impl(n_total: int = 500, init_infected: int = 70,
                      unroll: int = 8):
    """PMMH ``pf_impl`` factory routing the SIR filter through the
    whole-sweep op (BPF; SIS, SISR or SISAR; stratified or systematic).

    Usage: ``pf = sir_sweep_pf_impl(500, 70)(y, 128, ["lam", "gamma"],
    None, None, "BPF", "SISAR", "stratified", False, max_particles=128)``
    then ``pf(seed_words [C, 2], theta [C, 2], n)``.
    """
    from bayesssm_tpu_torch.ops.sir_sweep import sir_sweep_parts
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    parts = sir_sweep_parts(n_total, init_infected, unroll=unroll)
    return build_sweep_pf_impl(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        ("lam", "gamma"), num_obs_cols=2,
        obs_transform=parts["obs_transform"], kernel=parts["kernel"],
    )


def simulate_sir(seed=1405, n_total=500, init_infected=70, t_max=10,
                 lam=0.5, gamma=0.2):
    """Host-side exact simulation of one epidemic + Poisson observations:
    ``(states [t_max, 2], y [t_max])``, the same draws as the JAX
    package's ``simulate_sir`` for the same seed."""
    rng = np.random.default_rng(seed)
    s = float(n_total - init_infected)
    i = float(init_infected)
    states = np.zeros((t_max, 2))
    for t in range(t_max):
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
        states[t] = (s, i)
    y = rng.poisson(states[:, 1])
    return states, y.astype(np.float64)
