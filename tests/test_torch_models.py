"""The port's model zoo against the JAX package's: the README's sinusoidal
model, stochastic volatility, the vector-observation LGSS and SIR
tau-leaping.

Simulators and ``kalman_loglik_mv`` are NumPy in both packages and agree
exactly (to 1e-12). The engine (``filters/core.py``) on each model is held
to the JAX ``bootstrap_filter`` per key, each JAX reference an un-vmapped
jitted call: 1e-4 on the Gaussian models (f32 ulps of log, exp, sin and
erfinv over T days), 1e-3 on SIR (f32 ``lgamma``). Tau-leaping draws the
JAX function's binomials per key (``tests/test_torch_threefry.py`` holds
``binomial``); its moments are held to the exact Gillespie day as
``tests/test_models.py`` holds JAX's. Small ``pmmh()`` runs compare with
the JAX driver's validation messages, tuned counts and first sample.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.filters.bootstrap import bootstrap_filter as j_bpf
from bayesssm_tpu.models.lgss import (
    lgss_mv_model as j_lgss_mv_model,
    simulate_lgss_mv as j_simulate_lgss_mv,
)
from bayesssm_tpu.models.sinusoidal import (
    simulate_sinusoidal as j_simulate_sinusoidal,
    sinusoidal_model as j_sinusoidal_model,
)
from bayesssm_tpu.models.sir import (
    sir_model as j_sir_model,
    tau_leap_step as j_tau_leap_step,
)
from bayesssm_tpu.models.stochastic_volatility import (
    simulate_sv as j_simulate_sv,
    sv_model as j_sv_model,
)
from bayesssm_tpu.pmmh.driver import pmmh as j_pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control as j_tune
from bayesssm_tpu.utils.kalman import kalman_loglik_mv as j_kalman_mv
from bayesssm_tpu_torch.filters import bootstrap_filter
from bayesssm_tpu_torch.models.lgss import lgss_mv_model, simulate_lgss_mv
from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
    sinusoidal_sweep_pf_impl,
)
from bayesssm_tpu_torch.models.sir import (
    simulate_sir,
    sir_model,
    tau_leap_step,
)
from bayesssm_tpu_torch.models.stochastic_volatility import (
    simulate_sv,
    sv_model,
)
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.gillespie import gillespie_step
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh
from bayesssm_tpu_torch.utils.kalman import kalman_loglik_mv

torch.set_num_threads(1)

N = 128
KEYS = 4
TOL = 1e-4
SIN_THETA = dict(phi=0.8, sigma_x=1.0, sigma_y=0.5)
SV_THETA = dict(phi=0.95, sigma=0.3, mu=-1.0)
MV_THETA = dict(a=0.9, sigma_x=0.6, sigma_y=0.4)


def _key_data(first, count=KEYS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + count)])


def _jax_runs(fn, kd):
    f = jax.jit(lambda w: fn(jax.random.wrap_key_data(w)))
    return [f(jnp.asarray(w)) for w in kd]


def _check(res, runs, tol, fields=("loglike", "loglike_history",
                                   "state_est", "ess")):
    for field in fields:
        want = np.stack([np.asarray(getattr(r, field)) for r in runs])
        np.testing.assert_allclose(getattr(res, field).numpy(), want,
                                   rtol=0, atol=tol, err_msg=field)


@pytest.mark.parametrize("name", ["sinusoidal", "sv", "lgss_mv"])
def test_simulators_match_jax(name):
    ours, theirs = {
        "sinusoidal": (lambda: simulate_sinusoidal(7, 15),
                       lambda: j_simulate_sinusoidal(7, 15)),
        "sv": (lambda: simulate_sv(7, 30), lambda: j_simulate_sv(7, 30)),
        "lgss_mv": (lambda: simulate_lgss_mv(7, 12, c_vec=(1.0, 0.5, -2.0)),
                    lambda: j_simulate_lgss_mv(7, 12,
                                               c_vec=(1.0, 0.5, -2.0))),
    }[name]
    for a, b in zip(ours(), theirs()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c_vec,sy", [((1.0, 0.5), (0.4, 0.4)),
                                      ((1.0, -0.3, 2.0), (0.2, 0.5, 1.0))])
def test_kalman_loglik_mv_matches_jax(c_vec, sy):
    _, y = simulate_lgss_mv(3, 20, c_vec=c_vec)
    got = kalman_loglik_mv(y, 0.8, c_vec, 0.7, sy, m0=0.3, p0=1.5)
    assert got == pytest.approx(j_kalman_mv(y, 0.8, c_vec, 0.7, sy, m0=0.3,
                                            p0=1.5), abs=1e-12)
    with pytest.raises(ValueError, match="trailing dim"):
        kalman_loglik_mv(y, 0.8, (1.0,), 0.7, sy)
    with pytest.raises(ValueError, match=r"\[T, d_y\]"):
        kalman_loglik_mv(y[:, 0], 0.8, c_vec, 0.7, sy)


def _engine_case(name):
    """(port fns, JAX fns, y, theta) of one model."""
    if name == "sinusoidal":
        _, y = simulate_sinusoidal(11, 12)
        return (sinusoidal_model()[0], j_sinusoidal_model()[0], y,
                SIN_THETA)
    if name == "sv":
        _, y = simulate_sv(11, 15)
        return sv_model()[0], j_sv_model()[0], y, SV_THETA
    _, y = simulate_lgss_mv(11, 12)
    return lgss_mv_model()[0], j_lgss_mv_model()[0], y, MV_THETA


@pytest.mark.parametrize("name,algo,method", [
    ("sinusoidal", "SISAR", "stratified"), ("sinusoidal", "SIS", "systematic"),
    ("sv", "SISAR", "stratified"), ("sv", "SISR", "multinomial"),
    ("lgss_mv", "SISAR", "stratified"), ("lgss_mv", "SISR", "systematic"),
])
def test_engine_matches_jax_per_key(name, algo, method):
    (pi, pt, pl), (ji, jt, jl), y, theta = _engine_case(name)
    ys = np.asarray(y, np.float32)
    kd = _key_data(300)
    runs = _jax_runs(lambda k: j_bpf(
        k, ys, N, ji, jt, jl, theta=theta, resample_algorithm=algo,
        resample_fn=method, use_fused=False, return_particles=False), kd)
    res = bootstrap_filter(torch.as_tensor(kd.astype(np.int64)), ys, N, pi,
                           pt, pl, theta=theta, resample_algorithm=algo,
                           resample_fn=method, use_fused=False,
                           return_particles=False)
    assert torch.isfinite(res.loglike).all()
    _check(res, runs, TOL)


@pytest.mark.parametrize("name", ["sinusoidal", "sv"])
def test_engine_fused_weight_step_matches_jax_per_key(name):
    """The fused weight step with in-kernel positions (K3's route on the
    card; its plain version here) against JAX's interpret-mode kernel."""
    (pi, pt, pl), (ji, jt, jl), y, theta = _engine_case(name)
    ys = np.asarray(y, np.float32)
    kd = _key_data(320, 2)
    runs = _jax_runs(lambda k: j_bpf(
        k, ys, N, ji, jt, jl, theta=theta, use_fused="interpret-inkernel",
        return_particles=False), kd)
    res = bootstrap_filter(torch.as_tensor(kd.astype(np.int64)), ys, N, pi,
                           pt, pl, theta=theta,
                           use_fused="interpret-inkernel",
                           return_particles=False)
    _check(res, runs, TOL, fields=("loglike", "state_est"))


def test_tau_leap_moments_match_gillespie():
    """The analogue of ``tests/test_models.py::TestTauLeap``: one day from
    (430, 70) on 4096 lanes, 20 leaps against the exact jump process, with
    the JAX test's bounds."""
    lam, gamma, n_total = 0.5, 0.2, 500.0
    state = torch.tensor([430.0, 70.0]).expand(1, 4096, 2).contiguous()
    lam_t, gam_t = torch.tensor([lam]), torch.tensor([gamma])
    exact = gillespie_step(threefry.key(0)[None], state, lam_t, gam_t,
                           n_total)[0]
    leap = tau_leap_step(threefry.key(1)[None], state, lam_t, gam_t, n_total,
                         substeps=20)[0]
    i_e, i_l = exact[:, 1].numpy(), leap[:, 1].numpy()
    assert abs(i_e.mean() - i_l.mean()) < 2.5
    assert abs(i_e.std() - i_l.std()) < 2.0
    assert abs(exact[:, 0].numpy().mean() - leap[:, 0].numpy().mean()) < 2.5
    assert (leap >= 0).all() and (leap.sum(-1) <= n_total).all()


def test_tau_leap_step_matches_jax_per_key():
    """Every chain's day equals the JAX ``tau_leap_step`` for its key on
    at least 99% of the lanes (the rest: XLA's CPU ``log`` may put a
    geometric draw one integer off), at rates that send lanes to both
    binomial algorithms."""
    rng = np.random.default_rng(1)
    c, n = 6, 128
    s0 = rng.integers(200, 430, (c, n)).astype(np.float32)
    i0 = rng.integers(0, 150, (c, n)).astype(np.float32)
    state = np.stack([s0, i0], -1)
    lam = np.array([0.5, 0.9, 2.0, 5.0, 0.3, 8.0], np.float32)
    gam = np.array([0.2, 0.3, 0.1, 0.5, 0.25, 0.9], np.float32)
    kd = _key_data(40, c)
    f = jax.jit(lambda w, x, a, g: j_tau_leap_step(
        jax.random.wrap_key_data(w), x, a, g, 500.0, 10))
    want = np.stack([np.asarray(f(jnp.asarray(kd[j]), jnp.asarray(state[j]),
                                  lam[j], gam[j])) for j in range(c)])
    got = tau_leap_step(threefry.as_key_words(kd), torch.as_tensor(state),
                        torch.as_tensor(lam), torch.as_tensor(gam), 500.0,
                        10).numpy()
    share = (got == want).all(-1).mean(axis=1)
    assert (share >= 0.99).all(), share


def test_tauleap_model_runs_and_matches_jax_per_key():
    """``sir_model(transition="tauleap")`` no longer raises; the engine on
    it equals the JAX engine per key (SIR's 1e-3)."""
    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=5)
    ys = y.astype(np.float32)
    jfns, _, _ = j_sir_model(100, 10, transition="tauleap", substeps=5)
    pfns, _, transform = sir_model(100, 10, transition="tauleap",
                                   substeps=5)
    assert transform == {"lam": "log", "gamma": "log"}
    theta = dict(lam=0.4, gamma=0.25)
    kd = _key_data(60, 3)
    runs = _jax_runs(lambda k: j_bpf(k, ys, N, *jfns, theta=theta,
                                     use_fused=False,
                                     return_particles=False), kd)
    res = bootstrap_filter(torch.as_tensor(kd.astype(np.int64)), ys, N,
                           *pfns, theta=theta, use_fused=False,
                           return_particles=False)
    assert torch.isfinite(res.loglike).all()
    _check(res, runs, 1e-3, fields=("loglike", "state_est"))


README_INIT = [{"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
               {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8}]
SV_INIT = [{"phi": 0.9, "sigma": 0.4, "mu": -0.5},
           {"phi": 0.8, "sigma": 0.3, "mu": -1.5}]


def _model(name):
    if name == "sinusoidal":
        _, y = simulate_sinusoidal(1405, 15)
        return (sinusoidal_model(), j_sinusoidal_model(), y, README_INIT)
    _, y = simulate_sv(1405, 20)
    return sv_model(), j_sv_model(), y, SV_INIT


@pytest.mark.parametrize("name", ["sinusoidal", "sv"])
def test_pmmh_target_n_and_first_sample_match_the_jax_pmmh(name):
    """The README call (three parameters, phi on the identity, per-chain
    ``pilot_init_params``) and the SV call (phi in logit space) through
    both drivers on the engine: tuned counts equal, and with
    ``burn_in=0`` the first sample (the pilot mean) to 1e-5."""
    (fns, priors, transform), (jfns, jpriors, _), y, init = _model(name)
    tune = dict(pilot_m=20, pilot_reps=5, pilot_n=50)
    kw = dict(m=3, burn_in=0, num_chains=2, seed=11,
              param_transform=transform, pilot_init_params=init,
              print_summary=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_pmmh("bootstrap_filter", y, init_fn=jfns[0],
                      transition_fn=jfns[1], log_likelihood_fn=jfns[2],
                      log_priors=jpriors, tune_control=j_tune(**tune), **kw)
        got = pmmh("bootstrap_filter", y, init_fn=fns[0],
                   transition_fn=fns[1], log_likelihood_fn=fns[2],
                   log_priors=priors,
                   tune_control=default_tune_control(**tune),
                   device="cpu", **kw)
    np.testing.assert_array_equal(got.target_n, want.target_n)
    for q in got.theta_chain:
        np.testing.assert_allclose(got.theta_chain[q][:, 0],
                                   want.theta_chain[q][:, 0], rtol=0,
                                   atol=1e-5)


PMMH_VALIDATION = {
    "sv_phi_outside_beta_support": (
        "sv", dict(pilot_init_params=[{"phi": 1.5, "sigma": 0.3,
                                       "mu": -1.0}] * 2),
        "outside the prior support"),
    "readme_missing_transform_entry": (
        "sinusoidal", dict(param_transform={"phi": "identity"}),
        "every parameter"),
    "readme_param_name_mismatch": (
        "sinusoidal", dict(pilot_init_params=[{"phi": 0.5}] * 2),
        "do not match"),
}


@pytest.mark.parametrize("case", sorted(PMMH_VALIDATION))
def test_pmmh_validation_messages_match_jax(case):
    name, extra, match = PMMH_VALIDATION[case]
    (fns, priors, transform), (jfns, jpriors, _), y, init = _model(name)
    kw = dict(m=5, burn_in=1, num_chains=2, pilot_init_params=init,
              param_transform=transform, print_summary=False)
    kw.update(extra)
    with pytest.raises(ValueError, match=match) as got:
        pmmh("bootstrap_filter", y, init_fn=fns[0], transition_fn=fns[1],
             log_likelihood_fn=fns[2], log_priors=priors, device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        j_pmmh("bootstrap_filter", y, init_fn=jfns[0], transition_fn=jfns[1],
               log_likelihood_fn=jfns[2], log_priors=jpriors, **kw)
    assert str(got.value) == str(want.value)


def test_readme_pmmh_runs_through_the_sweep():
    """The README call through ``pf_impl=sinusoidal_sweep_pf_impl()`` in
    both phases (the plain sweep on the CPU): finite samples, phi inside
    its prior's support, counts in [50, 1000]. (The JAX driver vmaps its
    pilot, and a vmapped Pallas sweep draws another stream, so this path is
    held per key in ``tests/test_torch_sweep.py``.)"""
    (fns, priors, transform), _, y, init = _model("sinusoidal")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh("bootstrap_filter", y, 8, *fns, priors, init, 2,
                   num_chains=2, param_transform=transform, seed=3,
                   tune_control=default_tune_control(pilot_m=10,
                                                     pilot_reps=4),
                   pf_impl=sinusoidal_sweep_pf_impl(), print_summary=False,
                   device="cpu")
    assert set(out.theta_chain) == {"phi", "sigma_x", "sigma_y"}
    for arr in out.theta_chain.values():
        assert arr.shape == (2, 6) and np.isfinite(arr).all()
    phi = out.theta_chain["phi"]
    assert ((phi >= 0) & (phi <= 1)).all()
    assert ((out.target_n >= 50) & (out.target_n <= 1000)).all()
