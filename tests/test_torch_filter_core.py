"""The port's generic engine (``filters/core.py``) and its three filters
(bootstrap, auxiliary, resample-move) against the JAX package's, per key.

The port runs all keys of a case as one batch; each JAX reference is a
jitted call for one key (un-vmapped: a vmapped Pallas call would draw
another stream). Tolerances: LGSS 1e-4 in loglike, loglike history,
state estimates and ESS (f32 ulps of log, exp and erfinv, and sums in
another order); SIR 1e-3 in loglike (f32 ``lgamma`` ulps between the two
libraries, over T days).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.filters.auxiliary import auxiliary_filter as j_apf
from bayesssm_tpu.filters.bootstrap import bootstrap_filter as j_bpf
from bayesssm_tpu.filters.resample_move import resample_move_filter as j_rmpf
from bayesssm_tpu.models.distributions import norm_logpdf as j_norm
from bayesssm_tpu.models.lgss import lgss_model as j_lgss_model
from bayesssm_tpu.models.sir import (
    sir_aux_log_likelihood_fn as j_sir_aux,
    sir_model as j_sir_model,
    sir_move_fn as j_sir_move_fn,
)
from bayesssm_tpu.utils.signatures import adapt_move_fn as j_adapt_move_fn
from bayesssm_tpu_torch.filters import (
    FilterConfig,
    auxiliary_filter,
    bootstrap_filter,
    particle_filter_core,
    resample_move_filter,
)
from bayesssm_tpu_torch.filters.core import obs_times_to_gaps
from bayesssm_tpu_torch.models.distributions import norm_logpdf
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.models.sir import (
    simulate_sir,
    sir_aux_log_likelihood_fn,
    sir_model,
    sir_move_fn,
)
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.utils.signatures import adapt_move_fn

torch.set_num_threads(1)

N = 128
KEYS = 4
LGSS_THETA = dict(a=0.9, sigma_x=0.6, sigma_y=0.4)
N_TOTAL, I0 = 100, 10
SIR_THETA = dict(lam=0.4, gamma=0.25)
TOL = 1e-4
SIR_TOL = 1e-3


@pytest.fixture(scope="module")
def lgss_y():
    _, y = simulate_lgss(11, t_val=12)
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def sir_y():
    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=6)
    return y.astype(np.float32)


def _key_data(first, count=KEYS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + count)])


def _words(kd):
    return torch.as_tensor(kd.astype(np.int64))


def _jax_runs(fn, kd):
    f = jax.jit(lambda w: fn(jax.random.wrap_key_data(w)))
    return [f(jnp.asarray(w)) for w in kd]


def _stack(runs, field):
    return np.stack([np.asarray(getattr(r, field)) for r in runs])


def _check(res, runs, tol, fields=("loglike", "loglike_history",
                                   "state_est", "ess")):
    for field in fields:
        np.testing.assert_allclose(
            getattr(res, field).numpy(), _stack(runs, field), rtol=0,
            atol=tol, err_msg=field)


@functools.lru_cache(maxsize=None)
def _lgss_fns():
    return j_lgss_model()[0], lgss_model()[0]


@pytest.mark.parametrize("method", ["stratified", "systematic",
                                    "multinomial"])
@pytest.mark.parametrize("algo", ["SIS", "SISR", "SISAR"])
def test_lgss_portable_matches_jax(lgss_y, algo, method):
    (ji, jt, jl), (pi, pt, pl) = _lgss_fns()
    kd = _key_data(100)
    runs = _jax_runs(lambda k: j_bpf(
        k, lgss_y, N, ji, jt, jl, theta=LGSS_THETA, resample_algorithm=algo,
        resample_fn=method, use_fused=False, return_particles=False), kd)
    res = bootstrap_filter(_words(kd), lgss_y, N, pi, pt, pl,
                           theta=LGSS_THETA, resample_algorithm=algo,
                           resample_fn=method, use_fused=False,
                           return_particles=False)
    assert res.loglike.shape == (KEYS,)
    assert res.state_est.shape == (KEYS, len(lgss_y) + 1)
    assert res.particles_history is None and res.weights_history is None
    _check(res, runs, TOL)


@pytest.mark.parametrize("use_fused", [False, "interpret",
                                       "interpret-inkernel"])
def test_sir_gillespie_pallas_matches_jax(sir_y, use_fused):
    jfns, _, _ = j_sir_model(N_TOTAL, I0, transition="gillespie_pallas",
                             pallas_interpret=True)
    pfns, _, _ = sir_model(N_TOTAL, I0, transition="gillespie_pallas")
    kd = _key_data(200)
    runs = _jax_runs(lambda k: j_bpf(
        k, sir_y, N, *jfns, theta=SIR_THETA, use_fused=use_fused,
        return_particles=False), kd)
    res = bootstrap_filter(_words(kd), sir_y, N, *pfns, theta=SIR_THETA,
                           use_fused=use_fused, return_particles=False)
    assert res.state_est.shape == (KEYS, len(sir_y) + 1, 2)
    assert np.isfinite(res.loglike.numpy()).all()
    _check(res, runs, SIR_TOL, fields=("loglike", "loglike_history"))


def test_sir_masked_lanes_inkernel_matches_jax(sir_y):
    jfns, _, _ = j_sir_model(N_TOTAL, I0, transition="gillespie_pallas",
                             pallas_interpret=True)
    pfns, _, _ = sir_model(N_TOTAL, I0, transition="gillespie_pallas")
    kd = _key_data(300)
    runs = _jax_runs(lambda k: j_bpf(
        k, sir_y, 100, *jfns, theta=SIR_THETA, max_particles=N,
        use_fused="interpret-inkernel", resample_fn="systematic",
        return_particles=False), kd)
    res = bootstrap_filter(_words(kd), sir_y, 100, *pfns, theta=SIR_THETA,
                           max_particles=N, use_fused="interpret-inkernel",
                           resample_fn="systematic", return_particles=False)
    _check(res, runs, SIR_TOL, fields=("loglike", "loglike_history"))


@pytest.mark.parametrize("use_fused", [False, "interpret"])
def test_lgss_masked_lanes_and_carry_weights(lgss_y, use_fused):
    (ji, jt, jl), (pi, pt, pl) = _lgss_fns()
    kd = _key_data(400)
    kw = dict(theta=LGSS_THETA, max_particles=N, carry_weights=True,
              use_fused=use_fused, return_particles=False)
    runs = _jax_runs(lambda k: j_bpf(k, lgss_y, 100, ji, jt, jl, **kw), kd)
    res = bootstrap_filter(_words(kd), lgss_y, 100, pi, pt, pl, **kw)
    _check(res, runs, TOL)
    # Per-chain particle counts: each chain masks its own lanes.
    counts = torch.tensor([100.0, 128.0, 64.0, 100.0])
    mixed = bootstrap_filter(_words(kd), lgss_y, counts, pi, pt, pl, **kw)
    for k in (0, 3):
        np.testing.assert_array_equal(mixed.loglike[k].numpy(),
                                      res.loglike[k].numpy())


def test_lgss_obs_times_gaps(lgss_y):
    (ji, jt, jl), (pi, pt, pl) = _lgss_fns()
    obs_times = [1, 2, 4, 5, 8, 9, 10, 11, 13, 14, 15, 18]
    assert obs_times_to_gaps(obs_times, 12) == (1, 1, 2, 1, 3, 1, 1, 1, 2,
                                                1, 1, 3)
    kd = _key_data(500)
    runs = _jax_runs(lambda k: j_bpf(
        k, lgss_y, N, ji, jt, jl, theta=LGSS_THETA, obs_times=obs_times,
        use_fused=False, return_particles=False), kd)
    res = bootstrap_filter(_words(kd), lgss_y, N, pi, pt, pl,
                           theta=LGSS_THETA, obs_times=obs_times,
                           use_fused=False, return_particles=False)
    _check(res, runs, TOL)


def test_degenerate_day_gives_neg_inf(lgss_y):
    def j_ll(y, particles, t):
        return jnp.where(t == 4, -1e9, -0.5 * (y - particles) ** 2)

    def p_ll(y, particles, t):
        return (torch.full_like(particles, -1e9) if t == 4
                else -0.5 * (y - particles) ** 2)

    (ji, jt, _), (pi, pt, _) = _lgss_fns()
    kd = _key_data(600)
    runs = _jax_runs(lambda k: j_bpf(k, lgss_y, N, ji, jt, j_ll,
                                     theta=LGSS_THETA, use_fused=False), kd)
    res = bootstrap_filter(_words(kd), lgss_y, N, pi, pt, p_ll,
                           theta=LGSS_THETA, use_fused=False)
    hist = res.loglike_history.numpy()
    assert np.isneginf(res.loglike.numpy()).all()
    assert np.isfinite(hist[:, :3]).all() and np.isneginf(hist[:, 3:]).all()
    # From the dead day on, weights, ESS and state estimates are zero.
    assert (res.ess.numpy()[:, 4:] == 0).all()
    assert (res.weights_history.numpy()[:, 4:] == 0).all()
    assert (res.state_est.numpy()[:, 4:] == 0).all()
    _check(res, runs, TOL, fields=("loglike_history", "ess"))
    np.testing.assert_allclose(res.state_est.numpy(),
                               _stack(runs, "state_est"), rtol=0, atol=TOL)


@pytest.mark.parametrize("use_fused", [False, "interpret-inkernel"])
def test_return_particles_histories(lgss_y, use_fused):
    (ji, jt, jl), (pi, pt, pl) = _lgss_fns()
    kd = _key_data(700)
    runs = _jax_runs(lambda k: j_bpf(k, lgss_y, N, ji, jt, jl,
                                     theta=LGSS_THETA, use_fused=use_fused),
                     kd)
    res = bootstrap_filter(_words(kd), lgss_y, N, pi, pt, pl,
                           theta=LGSS_THETA, use_fused=use_fused)
    t = len(lgss_y)
    assert res.particles_history.shape == (KEYS, t + 1, N)
    assert res.weights_history.shape == (KEYS, t + 1, N)
    _check(res, runs, TOL, fields=("loglike", "particles_history",
                                   "weights_history", "state_est"))


def test_batched_equals_one_key_at_a_time(sir_y):
    pfns, _, _ = sir_model(N_TOTAL, I0, transition="gillespie_pallas")
    kd = _key_data(800, 8)
    lam = torch.linspace(0.3, 0.6, 8)
    kw = dict(return_particles=False, use_fused="interpret-inkernel")
    res = bootstrap_filter(_words(kd), sir_y, N, *pfns,
                           theta=dict(lam=lam, gamma=0.25), **kw)
    for k in range(8):
        one = bootstrap_filter(_words(kd[k:k + 1]), sir_y, N, *pfns,
                               theta=dict(lam=lam[k:k + 1], gamma=0.25),
                               **kw)
        assert torch.equal(one.loglike[0], res.loglike[k])
        assert torch.equal(one.state_est[0], res.state_est[k])


def test_two_dimensional_state_and_config(lgss_y):
    def init_fn(key, num_particles):
        from bayesssm_tpu_torch.ops import threefry
        return threefry.normal(key, (num_particles, 2))

    def transition_fn(key, particles):
        from bayesssm_tpu_torch.ops import threefry
        return 0.9 * particles + 0.3 * threefry.normal(
            key, particles.shape[1:])

    def loglik_fn(y, particles):
        return -0.5 * ((y - particles[..., 0]) ** 2) / 0.25

    cfg = FilterConfig(resample_algorithm="SISR", return_particles=True,
                       use_fused="interpret")
    res = particle_filter_core(_words(_key_data(900, 2)), lgss_y, 64,
                               init_fn, transition_fn, loglik_fn,
                               resample_algorithm="SIS", config=cfg)
    t = len(lgss_y)
    assert res.state_est.shape == (2, t + 1, 2)
    assert res.particles_history.shape == (2, t + 1, 64, 2)
    assert res.resample_algorithm == "SISR"
    assert (res.ess.numpy()[:, 1:] == 64).all()       # Q4 under SISR


# --- validation: the messages of tests/test_filter_core.py and
# tests/test_error_contracts.py for the bootstrap filter ---

def _ok_init(key, num_particles):
    return torch.zeros((key.shape[0], num_particles))


def _ok_trans(key, particles):
    return particles


def _ok_lik(y, particles):
    return torch.zeros_like(particles)


def _run(y=np.zeros(5), n=10, init=_ok_init, trans=_ok_trans, lik=_ok_lik,
         **kw):
    return bootstrap_filter(_words(_key_data(0, 1)), y, n, init, trans, lik,
                            **kw)


@pytest.mark.parametrize("kw,err,match", [
    (dict(n=0), ValueError, "num_particles must be a positive"),
    (dict(init=lambda key, num_particles: torch.zeros((1, num_particles + 1))),
     ValueError, "init_fn must return num_particles"),
    (dict(init=lambda key, num_particles: torch.zeros(
        (1, num_particles + 1, 2))),
     ValueError, "init_fn must return num_particles rows"),
    (dict(trans=lambda key, particles: particles[:, :-1]), ValueError,
     "transition_fn must return num_particles"),
    (dict(lik=lambda y, particles: torch.zeros((1, 11))), ValueError,
     "weight_fn must return num_particles"),
    (dict(y="hi"), ValueError, "y must be numeric"),
    (dict(obs_times=[1, 2, 3, 4]), ValueError, "one entry per observation"),
    (dict(obs_times="hi"), ValueError, "obs_times must be numeric"),
    (dict(obs_times=[1.5, 2.5, 3.5, 4.5, 5.5]), ValueError,
     "obs_times must be integers"),
    (dict(obs_times=[1, 2, 3, 5, 4]), ValueError, "strictly increasing"),
    (dict(init=lambda key: torch.zeros((1, 10))), ValueError,
     "init_fn does not contain 'num_particles'"),
    (dict(trans=lambda key: key), ValueError,
     "transition_fn does not contain 'particles'"),
    (dict(lik=lambda particles: particles), ValueError,
     "weight_fn does not contain 'y'"),
    (dict(resample_algorithm="XX"), ValueError, "resample_algorithm must be"),
    (dict(resample_fn="bogus"), ValueError, "resample_fn must be one of"),
    (dict(n=torch.tensor([10.0])), ValueError,
     "max_particles is required"),
    # Metropolis runs on the portable path only (the JAX engine's gate).
    (dict(resample_fn="metropolis", use_fused=True), ValueError,
     "inverse-CDF selection only"),
])
def test_validation_messages(kw, err, match):
    with pytest.raises(err, match=match):
        _run(**kw)


def test_engine_errors_and_unported_options():
    words = _words(_key_data(0, 1))
    args = (words, np.zeros(5), 8, _ok_init, _ok_trans, _ok_lik)
    with pytest.raises(ValueError, match="APF requires aux_weight_fn"):
        particle_filter_core(*args, algorithm="APF")
    with pytest.raises(ValueError, match="RMPF requires a move_fn"):
        particle_filter_core(*args, algorithm="RMPF")
    with pytest.raises(ValueError, match="algorithm must be one of"):
        particle_filter_core(*args, algorithm="XXX")
    # APF and RMPF run through the engine now.
    apf = particle_filter_core(*args, algorithm="APF", aux_weight_fn=_ok_lik)
    rmpf = particle_filter_core(*args, algorithm="RMPF",
                                move_fn=lambda key, particles: particles)
    for res, algo in ((apf, "APF"), (rmpf, "RMPF")):
        assert res.algorithm == algo and res.loglike.shape == (1,)
        assert np.isfinite(res.loglike.numpy()).all()
    assert (rmpf.ess.numpy() == 8).all()              # RMPF forces SISR
    # particle_axis is ported: it needs a current mesh naming the axis (as
    # JAX needs shard_map), and an axis size dividing the lanes.
    with pytest.raises(NameError, match="unbound axis name"):
        particle_filter_core(*args, particle_axis="p", particle_axis_size=2)
    with pytest.raises(ValueError, match="divisible by particle_axis_size"):
        particle_filter_core(*args, particle_axis="p", particle_axis_size=3)
    with pytest.raises(ValueError, match="chain key words"):
        particle_filter_core(words[0], *args[1:])
    with pytest.raises(ValueError, match="threshold must be non-negative"):
        FilterConfig(threshold=-1.0)


def test_check_params_match_mirrors_jax():
    from bayesssm_tpu.utils.signatures import check_params_match as j_check
    from bayesssm_tpu_torch.utils.signatures import check_params_match

    (init_fn, trans_fn, ll_fn), priors, _ = lgss_model()
    params = dict(a=0.5, sigma_x=1.0, sigma_y=1.0)
    for check in (check_params_match, j_check):
        check(init_fn, trans_fn, ll_fn, params, priors)
        with pytest.raises(ValueError, match="pilot_init_params"):
            check(init_fn, trans_fn, ll_fn, dict(a=0.5), priors)
        with pytest.raises(ValueError, match="names in log_priors"):
            check(init_fn, trans_fn, ll_fn, params, dict(a=None))
        with pytest.raises(ValueError, match="log_likelihood_fn does not "
                                             "contain 'y'"):
            check(init_fn, trans_fn, lambda particles: particles, params,
                  priors)


# --- APF and RMPF through the engine ---

MOVE_SD = 0.3


def j_lgss_move(key, particles, y, sigma_y):
    k1, k2 = jax.random.split(key)
    prop = particles + MOVE_SD * jax.random.normal(k1, particles.shape)
    la = j_norm(y, prop, sigma_y) - j_norm(y, particles, sigma_y)
    acc = jnp.log(jax.random.uniform(k2, particles.shape)) < la
    return jnp.where(acc, prop, particles)


def p_lgss_move(key, particles, y, sigma_y):
    k1, k2 = threefry.split(key).unbind(-2)
    shape = particles.shape[1:]
    prop = particles + MOVE_SD * threefry.normal(k1, shape)
    sd = sigma_y[:, None]
    la = norm_logpdf(y, prop, sd) - norm_logpdf(y, particles, sd)
    acc = torch.log(threefry.uniform(k2, shape)) < la
    return torch.where(acc, prop, particles)


def j_lgss_move_one(key, particle, y, sigma_y):
    """A reference-style move written for one particle."""
    k1, k2 = jax.random.split(key)
    prop = particle + MOVE_SD * jax.random.normal(k1)
    la = j_norm(y, prop, sigma_y) - j_norm(y, particle, sigma_y)
    return jnp.where(jnp.log(jax.random.uniform(k2)) < la, prop, particle)


def p_lgss_move_one(key, particle, y, sigma_y):
    k1, k2 = threefry.split(key).unbind(-2)
    prop = particle + MOVE_SD * threefry.normal(k1)
    la = norm_logpdf(y, prop, sigma_y) - norm_logpdf(y, particle, sigma_y)
    return torch.where(torch.log(threefry.uniform(k2)) < la, prop, particle)


LGSS_VARIANTS = {
    # APF with the Gaussian weight as the lookahead.
    "APF": (lambda ji, jt, jl: (j_apf, (ji, jt, jl, jl)),
            lambda pi, pt, pl: (auxiliary_filter, (pi, pt, pl, pl))),
    "RMPF": (lambda ji, jt, jl: (j_rmpf, (ji, jt, jl, j_lgss_move)),
             lambda pi, pt, pl: (resample_move_filter,
                                 (pi, pt, pl, p_lgss_move))),
    "RMPF-one-particle": (
        lambda ji, jt, jl: (j_rmpf, (ji, jt, jl, j_lgss_move_one)),
        lambda pi, pt, pl: (resample_move_filter,
                            (pi, pt, pl, p_lgss_move_one))),
}


def _variant(name):
    (ji, jt, jl), (pi, pt, pl) = _lgss_fns()
    j_make, p_make = LGSS_VARIANTS[name]
    return j_make(ji, jt, jl), p_make(pi, pt, pl)


@pytest.mark.parametrize("use_fused", [False, "interpret",
                                       "interpret-inkernel"])
@pytest.mark.parametrize("variant", sorted(LGSS_VARIANTS))
def test_lgss_apf_rmpf_match_jax(lgss_y, variant, use_fused):
    """Every weight-step route of APF and RMPF on LGSS, with masked lanes
    (100 of 128), to 1e-4."""
    (j_filter, j_fns), (p_filter, p_fns) = _variant(variant)
    kd = _key_data(1000)
    kw = dict(theta=LGSS_THETA, max_particles=N, use_fused=use_fused,
              return_particles=False)
    runs = _jax_runs(lambda k: j_filter(k, lgss_y, 100, *j_fns, **kw), kd)
    res = p_filter(_words(kd), lgss_y, 100, *p_fns, **kw)
    assert res.algorithm == variant[:4]
    _check(res, runs, TOL)


@pytest.mark.parametrize("use_fused", [False, "interpret"])
def test_lgss_apf_carry_weights_matches_jax(lgss_y, use_fused):
    """``carry_weights=True`` under APF: the aux resample takes the carried
    weights, the day's increment the uniform ones."""
    (j_filter, j_fns), (p_filter, p_fns) = _variant("APF")
    kd = _key_data(1100)
    kw = dict(theta=LGSS_THETA, carry_weights=True, use_fused=use_fused,
              return_particles=False)
    runs = _jax_runs(lambda k: j_filter(k, lgss_y, N, *j_fns, **kw), kd)
    res = p_filter(_words(kd), lgss_y, N, *p_fns, **kw)
    _check(res, runs, TOL)


@pytest.mark.parametrize("use_fused", [False, "interpret",
                                       "interpret-inkernel"])
@pytest.mark.parametrize("algo", ["APF", "RMPF"])
def test_sir_apf_rmpf_gillespie_pallas_match_jax(sir_y, algo, use_fused):
    """APF (``sir_aux_log_likelihood_fn``, K4 twice a day) and RMPF
    (``sir_move_fn``) on ``transition="gillespie_pallas"``, to 1e-3."""
    jfns, _, _ = j_sir_model(N_TOTAL, I0, transition="gillespie_pallas",
                             pallas_interpret=True)
    pfns, _, _ = sir_model(N_TOTAL, I0, transition="gillespie_pallas")
    kd = _key_data(1200, 2)
    kw = dict(theta=SIR_THETA, use_fused=use_fused, return_particles=False)
    if algo == "APF":
        runs = _jax_runs(lambda k: j_apf(k, sir_y, N, *jfns, j_sir_aux,
                                         **kw), kd)
        res = auxiliary_filter(_words(kd), sir_y, N, *pfns,
                               sir_aux_log_likelihood_fn, **kw)
    else:
        runs = _jax_runs(lambda k: j_rmpf(
            k, sir_y, N, *jfns, j_sir_move_fn(N_TOTAL), **kw), kd)
        res = resample_move_filter(_words(kd), sir_y, N, *pfns,
                                   sir_move_fn(N_TOTAL), **kw)
    assert np.isfinite(res.loglike.numpy()).all()
    _check(res, runs, SIR_TOL)


def test_sir_move_and_aux_fns_match_jax():
    """``sir_move_fn`` (threefry ``randint`` and ``uniform`` from the two
    halves of ``split(key)``) exactly, per key; ``sir_aux_log_likelihood_fn``
    to 1e-5, the f32 ``lgamma(y + 1)`` ulps between the two libraries
    (the move's ratio cancels that term)."""
    rng = np.random.default_rng(5)
    c, n, y = 6, 200, np.float32(23.0)
    s = rng.integers(300, 430, size=(c, n)).astype(np.float32)
    i = np.minimum(rng.integers(0, 60, size=(c, n)), 500 - s)
    i[:, :5] = 0.0
    i[0, 5:9] = 500.0 - s[0, 5:9]               # on the support's edge
    parts = np.stack([s, i.astype(np.float32)], axis=-1)
    kd = _key_data(1300, c)
    j_move = jax.jit(j_sir_move_fn(500, 2))
    want = np.stack([np.asarray(j_move(
        jax.random.wrap_key_data(jnp.asarray(kd[k])), jnp.asarray(parts[k]),
        jnp.asarray(y), 0.5, 0.2)) for k in range(c)])
    pt = torch.as_tensor(parts)
    got = sir_move_fn(500, 2)(_words(kd), pt, torch.tensor(y),
                              torch.full((c,), 0.5), torch.full((c,), 0.2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != parts).any()         # some proposals accepted
    np.testing.assert_allclose(
        sir_aux_log_likelihood_fn(torch.tensor(y), pt).numpy(),
        np.stack([np.asarray(j_sir_aux(jnp.asarray(y), jnp.asarray(p)))
                  for p in parts]), rtol=0, atol=1e-5)


def test_adapt_move_fn_matches_jax_and_refuses_python_branches():
    kd = _key_data(1400, 3)
    parts = np.random.default_rng(2).normal(size=(3, 50)).astype(np.float32)
    sy = np.array([0.4, 0.5, 0.6], np.float32)
    j_move = j_adapt_move_fn(j_lgss_move_one)
    want = np.stack([np.asarray(j_move(
        key=jax.random.wrap_key_data(jnp.asarray(kd[k])),
        particles=jnp.asarray(parts[k]), y=jnp.float32(0.3), t=1,
        sigma_y=sy[k])) for k in range(3)])
    got = adapt_move_fn(p_lgss_move_one)(
        key=_words(kd), particles=torch.as_tensor(parts),
        y=torch.tensor(0.3), t=1, sigma_y=torch.as_tensor(sy))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # A batched move is called as it is.
    assert adapt_move_fn(p_lgss_move)(
        key=_words(kd), particles=torch.as_tensor(parts),
        y=torch.tensor(0.3), t=1,
        sigma_y=torch.as_tensor(sy)).shape == (3, 50)

    def branchy(key, particle):
        return particle + 1.0 if float(particle) > 0 else particle

    with pytest.raises(ValueError, match="torch.func.vmap"):
        adapt_move_fn(branchy)(key=_words(kd),
                               particles=torch.as_tensor(parts))


def test_apf_degenerate_aux_weights_give_neg_inf(lgss_y):
    """Every aux log-weight below -1e8 on one day kills the chain on every
    route (the fused routes' -1e30 clamp must not cancel)."""
    (_, _), (p_filter, (pi, pt, pl, _)) = _variant("APF")

    def bad_aux(y, particles, t):
        return torch.full_like(particles, -1e9 if t == 3 else 0.0)

    for use_fused in (False, "interpret", "interpret-inkernel"):
        res = p_filter(_words(_key_data(1500, 2)), lgss_y, N, pi, pt, pl,
                       bad_aux, theta=LGSS_THETA, use_fused=use_fused,
                       return_particles=False)
        assert np.isneginf(res.loglike.numpy()).all()
        assert np.isfinite(res.loglike_history.numpy()[:, :2]).all()
