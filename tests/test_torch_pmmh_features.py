"""The port's ``pmmh()`` features, the mirror of ``tests/test_pmmh_features.py``:
observation gaps, a two-dimensional state, the APF and RMPF variants,
``jacobian_convention="reference"``, verbose progress, timings, the
burn-in edges of the sampling chunks, and chunked sampling against the
unchunked run. The MH steps draw from the port's own stream, so each test
holds the port to the JAX test's claim, not to its numbers; the model
functions are the engine's batched ones (``key [C, 2]``, ``[C]``
parameters).
"""

import warnings

import numpy as np
import torch

from bayesssm_tpu_torch.models.distributions import (
    exp_logpdf,
    norm_logpdf,
    unif_logpdf,
)
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

torch.set_num_threads(1)

FAST_TUNE = default_tune_control(pilot_m=50, pilot_reps=8, pilot_n=50)
LGSS_INIT = [{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}] * 2


def quiet_pmmh(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pmmh(print_summary=False, device="cpu", **kw)


def lgss_kw(y, **kw):
    (init_fn, trans_fn, loglik_fn), log_priors, transform = lgss_model()
    return dict(pf_wrapper="bootstrap_filter", y=y, init_fn=init_fn,
                transition_fn=trans_fn, log_likelihood_fn=loglik_fn,
                log_priors=log_priors, param_transform=transform,
                tune_control=FAST_TUNE, **kw)


def test_pmmh_with_obs_times():
    _, y_full = simulate_lgss(11, t_val=12)
    obs_times = [1, 2, 3, 5, 6, 7, 9, 10, 11, 12]
    y = y_full[np.array(obs_times) - 1]
    out = quiet_pmmh(**lgss_kw(
        y, m=60, pilot_init_params=LGSS_INIT, burn_in=10, num_chains=2,
        seed=5, obs_times=obs_times, return_latent_state_est=True))
    assert out.latent_state_chain.shape == (2, 50, len(obs_times) + 1)
    for p in out.theta_chain:
        assert np.isfinite(out.theta_chain[p]).all()


def test_pmmh_multidim_state():
    # A 2-D latent state through the whole driver (test-pmmh.R:618-668).
    rng = np.random.default_rng(4)
    t_len = 12
    x = np.zeros((t_len + 1, 2))
    y = np.zeros(t_len)
    for t in range(t_len):
        x[t + 1] = 0.8 * x[t] + 0.5 * rng.normal(size=2)
        y[t] = x[t + 1, 0] + x[t + 1, 1] + 0.3 * rng.normal()

    def init_fn(key, num_particles):
        return threefry.normal(key, (num_particles, 2))

    def transition_fn(key, particles, rho):
        return (rho[:, None, None] * particles
                + 0.5 * threefry.normal(key, particles.shape[1:]))

    def loglik_fn(y, particles, sigma_y):
        mu = particles[..., 0] + particles[..., 1]
        return norm_logpdf(y, mu, sigma_y[:, None])

    log_priors = {
        "rho": lambda v: unif_logpdf(v, -1.0, 1.0),
        "sigma_y": lambda v: exp_logpdf(v, 1.0),
    }
    out = quiet_pmmh(
        pf_wrapper="bootstrap_filter", y=y, m=80, init_fn=init_fn,
        transition_fn=transition_fn, log_likelihood_fn=loglik_fn,
        log_priors=log_priors,
        pilot_init_params=[{"rho": 0.5, "sigma_y": 0.5}] * 2, burn_in=20,
        num_chains=2, seed=6,
        param_transform={"rho": "identity", "sigma_y": "log"},
        tune_control=FAST_TUNE, return_latent_state_est=True)
    # The latent estimates keep the state dimension.
    assert out.latent_state_chain.shape == (2, 60, t_len + 1, 2)
    assert np.isfinite(out.latent_state_chain).all()


def test_pmmh_apf_variant():
    _, y = simulate_lgss(12, t_val=10)

    def aux_fn(y, particles, a, sigma_y):
        return norm_logpdf(y, a[:, None] * particles, sigma_y[:, None])

    out = quiet_pmmh(**lgss_kw(
        y, m=50, aux_log_likelihood_fn=aux_fn, pilot_init_params=LGSS_INIT,
        burn_in=10, num_chains=2, seed=7))
    for p in out.theta_chain:
        assert np.isfinite(out.theta_chain[p]).all()


def test_pmmh_rmpf_variant():
    _, y = simulate_lgss(13, t_val=10)

    def move_fn(key, particles, y, sigma_y):
        k1, k2 = threefry.split(key).unbind(-2)
        shape = particles.shape[1:]
        prop = particles + 0.1 * threefry.normal(k1, shape)
        sd = sigma_y[:, None]
        la = norm_logpdf(y, prop, sd) - norm_logpdf(y, particles, sd)
        acc = torch.log(threefry.uniform(k2, shape)) < la
        return torch.where(acc, prop, particles)

    out = quiet_pmmh(**lgss_kw(
        y, m=50, move_fn=move_fn, pilot_init_params=LGSS_INIT, burn_in=10,
        num_chains=2, seed=8))
    for p in out.theta_chain:
        assert np.isfinite(out.theta_chain[p]).all()


def test_reference_jacobian_convention():
    _, y = simulate_lgss(14, t_val=8)
    out = quiet_pmmh(**lgss_kw(
        y, m=40, pilot_init_params=LGSS_INIT, burn_in=5, num_chains=2,
        seed=9, jacobian_convention="reference"))
    for p in out.theta_chain:
        assert np.isfinite(out.theta_chain[p]).all()


def test_verbose_progress_reports_acceptance(capsys):
    # With verbose=True the sampling loop prints each chunk's step count
    # and acceptance rates (R/pmmh.R:347-352).
    _, y = simulate_lgss(2, t_val=6)
    kw = lgss_kw(y, m=9, pilot_init_params={"a": 0.5, "sigma_x": 0.5,
                                            "sigma_y": 0.5},
                 burn_in=2, num_chains=2, seed=3, verbose=True,
                 progress_every=4)
    kw["tune_control"] = default_tune_control(pilot_m=20, pilot_burn_in=5,
                                              pilot_reps=3)
    quiet_pmmh(**kw)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Sampling:")]
    # m = 9, the first sample from the initial evaluation, chunks of 4:
    # reports at 5 and 9.
    assert len(lines) == 2, out
    assert "5/9 steps" in lines[0] and "9/9 steps" in lines[1]
    for ln in lines:
        assert "acceptance chunk" in ln and "cumulative" in ln


def test_timings_include_all_phases():
    _, y = simulate_lgss(3, t_val=6)
    out = quiet_pmmh(**lgss_kw(
        y, m=10, pilot_init_params={"a": 0.8, "sigma_x": 0.5,
                                    "sigma_y": 0.4},
        burn_in=2, num_chains=2, seed=5))
    for phase in ("tuning", "compile", "sampling"):
        assert phase in out.timings, out.timings
        assert out.timings[phase] >= 0.0


def test_fast_path_burn_in_edges():
    """The chunk schedule gives ``[C, m - burn_in]`` chains at every
    burn-in edge, including an m that spans the 256-step chunk."""
    _, y = simulate_lgss(31, t_val=6)
    for m, burn_in in ((12, 0), (12, 1), (12, 11), (300, 20), (2, 1)):
        out = quiet_pmmh(**lgss_kw(
            y, m=m, pilot_init_params=LGSS_INIT, burn_in=burn_in,
            num_chains=2, seed=5))
        for p in out.theta_chain:
            assert out.theta_chain[p].shape == (2, m - burn_in), (
                m, burn_in, out.theta_chain[p].shape)
            assert np.isfinite(out.theta_chain[p]).all()


def test_fast_path_matches_progress_path():
    """Chunked sampling with progress reports samples the same chains as
    the unchunked run, bit for bit."""
    _, y = simulate_lgss(33, t_val=6)
    kw = lgss_kw(y, m=40, pilot_init_params=LGSS_INIT, burn_in=10,
                 num_chains=2, seed=9)
    fast = quiet_pmmh(**kw)
    chunked = quiet_pmmh(progress_every=7, verbose=False, **kw)
    for p in fast.theta_chain:
        np.testing.assert_array_equal(fast.theta_chain[p],
                                      chunked.theta_chain[p])
