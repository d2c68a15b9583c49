"""The system under test's stochastic-volatility filter, built as a user
builds it: three ``torch`` callbacks given to the public
``build_sweep_pf_impl`` factory, so that on the card they run as the
functor generated from them (K1 with it: ``ops/sweep_codegen.py``,
``ops/_build.py::build_generated``). Bootstrap filter, SISAR,
stratified, as ``pmmh()`` builds it with this ``pf_impl``.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * np.log(2.0 * np.pi)


def sv_init(rng, theta):
    phi, sigma, mu = theta
    sd0 = sigma / torch.sqrt(1.0 - phi * phi)
    return (mu + sd0 * rng.normal(),)


def sv_transition(rng, cols, theta, t):
    phi, sigma, mu = theta
    return (mu + phi * (cols[0] - mu) + sigma * rng.normal(),)


def sv_log_weight(cols, theta, y_t):
    x = cols[0]
    return -HALF_LOG_2PI - 0.5 * x - 0.5 * y_t * y_t * torch.exp(-x)


def sv_pf_impl():
    """The ``pf_impl`` factory of the callbacks above."""
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    return build_sweep_pf_impl(
        num_state_cols=1,
        init_fn=sv_init,
        transition_fn=sv_transition,
        log_weight_fn=sv_log_weight,
        param_names=("phi", "sigma", "mu"),
    )


def build(cfg: dict, path: str, y, particles: int, lanes: int):
    """``(pf, prior_fns)``: ``pf(seed_words [C, 2], theta [C, 3], n)``
    and ``sv_model()``'s priors in ``("phi", "sigma", "mu")`` order."""
    from bayesssm_tpu_torch.models.stochastic_volatility import sv_model

    del cfg
    if path != "sweep":
        raise ValueError(f"unknown SV filter path {path!r}")
    _, log_priors, _ = sv_model()
    names = ["phi", "sigma", "mu"]
    pf = sv_pf_impl()(y, particles, names, None, None, "BPF", "SISAR",
                      "stratified", False, max_particles=lanes)
    return pf, [log_priors[q] for q in names]
