"""Posterior parity of the port on the reference's benchmark models, the
mirror of ``tests/test_parity.py``: the README configuration held to the
reference README's posterior table, and the SIR vignette configuration to
its generating truth, each within the JAX test's 3-SE band. The band and
the anchor are the port's own copies (``examples/torch_sinusoidal_readme.py``,
which ``chip_smoke.py`` phase 29 also holds the README example to on the
card); the first test checks them against the JAX test's. The two runs
are marked ``slow``, as the JAX ones are.
"""

import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

import test_parity
from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
)
from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_sinusoidal_readme", pathlib.Path(__file__).resolve().parent.parent
    / "examples" / "torch_sinusoidal_readme.py")
README = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(README)


def test_band_and_anchor_are_the_jax_test_s():
    assert README.README_ANCHOR == test_parity.README_ANCHOR
    rng = np.random.default_rng(3)
    for sd, ess_, sd_ref, ess_ref in rng.uniform(0.0, 40.0, size=(20, 4)):
        assert README.se_bound(sd, ess_, sd_ref, ess_ref) == (
            test_parity.se_bound(sd, ess_, sd_ref, ess_ref))


@pytest.mark.slow
def test_sinusoidal_readme_config():
    # The README configuration: T = 20, m = 500, burn_in = 50, 2 chains,
    # pilot_m = 200. Truth: phi = 0.8, sigma_x = 1, sigma_y = 0.5.
    (init_fn, trans_fn, loglik_fn), log_priors, transform = sinusoidal_model()
    _, y = simulate_sinusoidal(seed=1405)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh(
            "bootstrap_filter", y, m=500,
            init_fn=init_fn, transition_fn=trans_fn,
            log_likelihood_fn=loglik_fn, log_priors=log_priors,
            pilot_init_params=[
                {"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
                {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8},
            ],
            burn_in=50, num_chains=2, seed=1405,
            param_transform=transform,
            tune_control=default_tune_control(pilot_m=200, pilot_reps=50),
            print_summary=False, device="cpu",
        )
    summ = out.summary()
    assert (out.target_n >= 50).all() and (out.target_n <= 1000).all()
    for param, (m_ref, sd_ref, ess_ref) in README.README_ANCHOR.items():
        m_ours = summ[param]["mean"]
        bound = README.se_bound(summ[param]["sd"], summ[param]["ESS"],
                                sd_ref, ess_ref)
        assert abs(m_ours - m_ref) < bound, (
            f"{param}: |{m_ours:.3f} - {m_ref}| >= {bound:.3f}")
    # The credible interval covers the truth.
    assert (summ["phi"]["2.5%"] < 0.8 < summ["phi"]["97.5%"]
            or summ["phi"]["mean"] > 0.5)


@pytest.mark.slow
def test_sir_vignette_config():
    # The vignette configuration (stochastic-sir-model.Rmd:316-336), m
    # shortened from 1000 as in the JAX test; the anchor is the truth
    # (lambda = 0.5, gamma = 0.2).
    (init_fn, trans_fn, loglik_fn), log_priors, transform = sir_model()
    _, y = simulate_sir(seed=1405)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh(
            "bootstrap_filter", y, m=400,
            init_fn=init_fn, transition_fn=trans_fn,
            log_likelihood_fn=loglik_fn, log_priors=log_priors,
            pilot_init_params=[
                {"lam": 0.5, "gamma": 0.5},
                {"lam": 1.0, "gamma": 1.0},
            ],
            burn_in=100, num_chains=2, seed=1405,
            param_transform=transform,
            tune_control=default_tune_control(pilot_m=100, pilot_reps=20),
            print_summary=False, device="cpu",
        )
    summ = out.summary()
    for param, truth in (("lam", 0.5), ("gamma", 0.2)):
        bound = README.se_bound(summ[param]["sd"], summ[param]["ESS"], 0.0,
                                1.0)
        assert abs(summ[param]["mean"] - truth) < bound, (
            f"{param}: |{summ[param]['mean']:.3f} - {truth}| >= {bound:.3f}")
