"""The port's public ``pmmh()`` (bayesssm_tpu_torch/pmmh/driver.py) against
the JAX package's ``pmmh()``.

The validation cases and messages mirror ``tests/test_pmmh.py``. Per key,
the port's phase 1 and its first log-likelihood follow the JAX driver
(module docstring of the port's driver): on the same LGSS call the tuned
particle counts are equal and the first sample (the pilot mean, with
``burn_in=0``) agrees to 1e-5. The MH steps draw from another stream, so
the posterior is held to the truth as ``tests/test_pmmh.py`` holds the
JAX driver's.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from bayesssm_tpu.models.lgss import lgss_model as j_lgss_model
from bayesssm_tpu.pmmh.driver import pmmh as j_pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control as j_tune
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.models.sir import (
    simulate_sir,
    sir_model,
    sir_sweep_pf_impl,
)
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

torch.set_num_threads(1)

(MODEL_FNS, LOG_PRIORS, TRANSFORM) = lgss_model()
INIT_FN, TRANSITION_FN, LOGLIK_FN = MODEL_FNS
_, Y = simulate_lgss(1405, t_val=15)

FAST_TUNE = dict(pilot_m=60, pilot_reps=10, pilot_n=50)
TINY_TUNE = dict(pilot_m=6, pilot_reps=3, pilot_n=50)
INIT_PARAMS = [
    {"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5},
    {"a": 0.8, "sigma_x": 1.0, "sigma_y": 0.8},
    {"a": 0.3, "sigma_x": 0.7, "sigma_y": 0.4},
]


def run_small(m=12, burn_in=4, num_chains=2, seed=11, tune=TINY_TUNE, y=Y,
              pf_wrapper="bootstrap_filter", **kw):
    kw.setdefault("param_transform", TRANSFORM)
    kw.setdefault("pilot_init_params", INIT_PARAMS[:num_chains])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pmmh(
            pf_wrapper, y, m=m,
            init_fn=INIT_FN, transition_fn=TRANSITION_FN,
            log_likelihood_fn=LOGLIK_FN, log_priors=LOG_PRIORS,
            burn_in=burn_in, num_chains=num_chains, seed=seed,
            tune_control=default_tune_control(**tune),
            print_summary=False, device="cpu", **kw,
        )


def _call(**kw):
    args = dict(pf_wrapper="bootstrap_filter", y=Y, m=10, init_fn=INIT_FN,
                transition_fn=TRANSITION_FN, log_likelihood_fn=LOGLIK_FN,
                log_priors=LOG_PRIORS, pilot_init_params=INIT_PARAMS[:2],
                burn_in=1, num_chains=2, print_summary=False)
    args.update(kw)
    return args


_BAD_Y = np.array(Y, copy=True)
_BAD_Y[3] = np.nan

VALIDATION = {
    "burn_in_bounds": (dict(m=50, burn_in=50), "burn_in"),
    "bad_m": (dict(m=0), "m must"),
    "bad_num_chains": (dict(num_chains=0), "num_chains"),
    "empty_priors": (dict(log_priors={}), "log_priors"),
    "bad_pf_wrapper": (dict(pf_wrapper="not_a_filter"), "pf_wrapper"),
    "chain_count_mismatch": (dict(pilot_init_params=INIT_PARAMS[:1]),
                             "one entry per chain"),
    "param_name_mismatch": (dict(log_priors={"a": LOG_PRIORS["a"]},
                                 pilot_init_params=[{"a": 0.5}] * 2),
                            "do not match"),
    "init_outside_prior_support": (
        dict(pilot_init_params=[{"a": 0.5, "sigma_x": -1.0,
                                 "sigma_y": 0.5}] * 2),
        "outside the prior support"),
    "transform_missing_entry": (dict(param_transform={"a": "identity"}),
                                "every parameter"),
    "nan_in_y": (dict(y=_BAD_Y), "no missing values"),
    "apf_without_aux": (dict(pf_wrapper="auxiliary_filter"),
                        "aux_log_likelihood_fn"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_messages_match_jax(case):
    kw, match = VALIDATION[case]
    with pytest.raises(ValueError, match=match) as got:
        pmmh(**_call(**kw))
    with pytest.raises(ValueError) as want:
        j_pmmh(**_call(**kw))
    assert str(got.value) == str(want.value)


# Checkpointing (item 5) runs since it was ported: tests/test_torch_checkpoint.py.
# ``mesh`` (item 6) raised NotImplementedError naming its ROADMAP item until
# it was ported; it runs now (many ranks: tests/test_torch_sharding.py).
NOT_PORTED = {
    "mesh": dict(num_chains=2),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_unported_options_name_their_roadmap_item(case):
    """A one-process ``mesh`` (the 1 x 1 mesh of a process with no group)
    runs and equals the run without a mesh bit for bit."""
    import torch.distributed as dist

    from bayesssm_tpu_torch.parallel import make_chain_mesh

    had_group = dist.is_initialized()
    try:
        with_mesh = run_small(mesh=make_chain_mesh(devices="cpu"),
                              **NOT_PORTED[case])
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
    plain = run_small(**NOT_PORTED[case])
    for q in plain.theta_chain:
        np.testing.assert_array_equal(with_mesh.theta_chain[q],
                                      plain.theta_chain[q])
    np.testing.assert_array_equal(with_mesh.target_n, plain.target_n)


# The APF and RMPF cases that raised NotImplementedError above until the
# two filters were ported: they run now, on the CPU.
FILTER_VARIANTS = {
    "apf": dict(pf_wrapper="auxiliary_filter",
                aux_log_likelihood_fn=LOGLIK_FN),
    "rmpf": dict(pf_wrapper="resample_move_filter",
                 move_fn=lambda particles: particles),
}


@pytest.mark.parametrize("case", sorted(FILTER_VARIANTS))
def test_apf_and_rmpf_run(case):
    out = pmmh(**_call(m=4, seed=3, param_transform=TRANSFORM,
                       tune_control=default_tune_control(**TINY_TUNE),
                       device="cpu", **FILTER_VARIANTS[case]))
    for arr in out.theta_chain.values():
        assert arr.shape == (2, 3) and np.isfinite(arr).all()


def test_no_card_and_no_device_raises():
    """Without a card ``pmmh()`` refuses to pick the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: pmmh() runs there by default")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pmmh(**_call(m=3, tune_control=default_tune_control(**TINY_TUNE)))


def test_invalid_transform_warns():
    with pytest.warns(UserWarning, match="identity"):
        pmmh(**_call(m=3, param_transform={"a": "nope", "sigma_x": "log",
                                           "sigma_y": "log"},
                     tune_control=default_tune_control(**TINY_TUNE),
                     device="cpu"))


def test_output_structure_and_the_same_seed_gives_the_same_samples():
    out = run_small(seed=21)
    again = run_small(seed=21)
    other = run_small(seed=22)
    assert set(out.theta_chain) == {"a", "sigma_x", "sigma_y"}
    for q, arr in out.theta_chain.items():
        assert arr.shape == (2, 8) and np.isfinite(arr).all()
        np.testing.assert_array_equal(arr, again.theta_chain[q])
    assert not np.array_equal(out.theta_chain["a"], other.theta_chain["a"])
    assert set(out.diagnostics) == {"ess", "rhat"}
    assert set(out.diagnostics["ess"]) == {"a", "sigma_x", "sigma_y"}
    assert out.acceptance_rate.shape == (2,)
    assert ((out.acceptance_rate >= 0) & (out.acceptance_rate <= 1)).all()
    assert out.target_n.shape == (2,) and out.target_n.dtype == np.int64
    assert ((out.target_n >= 50) & (out.target_n <= 1000)).all()
    assert out.seed == 21
    assert list(out.timings) == ["tuning", "compile", "sampling"]
    assert out.timings["compile"] == 0.0


def test_transform_dict_order_does_not_change_the_chains():
    t1 = {"a": "identity", "sigma_x": "log", "sigma_y": "log"}
    t2 = {"sigma_y": "log", "a": "identity", "sigma_x": "log"}
    o1 = run_small(seed=31, param_transform=t1)
    o2 = run_small(seed=31, param_transform=t2)
    for q in o1.theta_chain:
        np.testing.assert_array_equal(o1.theta_chain[q], o2.theta_chain[q])


def _jax_and_port_first_samples(pf_wrapper, j_extra=None, p_extra=None,
                                tune=FAST_TUNE):
    kw = dict(m=3, burn_in=0, num_chains=3, seed=11,
              param_transform=TRANSFORM)
    j_fns, j_priors, _ = j_lgss_model()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_pmmh(pf_wrapper, Y, init_fn=j_fns[0],
                      transition_fn=j_fns[1], log_likelihood_fn=j_fns[2],
                      log_priors=j_priors, pilot_init_params=INIT_PARAMS,
                      tune_control=j_tune(**tune), print_summary=False,
                      **kw, **(j_extra or {}))
    got = run_small(tune=tune, pf_wrapper=pf_wrapper, **kw,
                    **(p_extra or {}))
    np.testing.assert_array_equal(got.target_n, want.target_n)
    for q in got.theta_chain:
        np.testing.assert_allclose(got.theta_chain[q][:, 0],
                                   want.theta_chain[q][:, 0], rtol=0,
                                   atol=1e-5)
    return got


def test_target_n_and_first_sample_match_the_jax_pmmh():
    """The same LGSS call (``FAST_TUNE`` of ``tests/test_pmmh.py``, three
    chains): the tuned counts are equal, and with ``burn_in=0`` the first
    sample is the pilot mean to 1e-5. (``tests/test_torch_tuning.py``
    holds a count inside (50, 1000) to JAX's per key.)"""
    _jax_and_port_first_samples("bootstrap_filter")


def _j_lgss_move(key, particles, y, sigma_y):
    from bayesssm_tpu.models.distributions import norm_logpdf as j_norm

    k1, k2 = jax.random.split(key)
    prop = particles + 0.3 * jax.random.normal(k1, particles.shape)
    la = j_norm(y, prop, sigma_y) - j_norm(y, particles, sigma_y)
    acc = jax.numpy.log(jax.random.uniform(k2, particles.shape)) < la
    return jax.numpy.where(acc, prop, particles)


def _p_lgss_move(key, particles, y, sigma_y):
    from bayesssm_tpu_torch.models.distributions import norm_logpdf
    from bayesssm_tpu_torch.ops import threefry

    k1, k2 = threefry.split(key).unbind(-2)
    prop = particles + 0.3 * threefry.normal(k1, particles.shape[1:])
    sd = sigma_y[:, None]
    la = norm_logpdf(y, prop, sd) - norm_logpdf(y, particles, sd)
    acc = torch.log(threefry.uniform(k2, particles.shape[1:])) < la
    return torch.where(acc, prop, particles)


@pytest.mark.parametrize("pf_wrapper", ["auxiliary_filter",
                                        "resample_move_filter"])
def test_apf_rmpf_target_n_and_first_sample_match_the_jax_pmmh(pf_wrapper):
    """The engine path of the two other filters, as the test above holds
    the bootstrap filter: APF with the Gaussian weight as its lookahead,
    RMPF with a random-walk move on x. Tuned counts equal, first sample to
    1e-5."""
    if pf_wrapper == "auxiliary_filter":
        j_extra = dict(aux_log_likelihood_fn=j_lgss_model()[0][2])
        p_extra = dict(aux_log_likelihood_fn=LOGLIK_FN)
    else:
        j_extra = dict(move_fn=_j_lgss_move)
        p_extra = dict(move_fn=_p_lgss_move)
    _jax_and_port_first_samples(pf_wrapper, j_extra, p_extra)


def test_a_jax_key_gives_the_int_seeds_run():
    """``seed`` as the [2] words of ``jax.random.key(11)`` runs the same
    chains as ``seed=11``; the output then reports no seed."""
    words = np.asarray(jax.random.key_data(jax.random.key(11)))
    by_key = run_small(seed=words)
    by_int = run_small(seed=11)
    assert by_key.seed is None
    for q in by_int.theta_chain:
        np.testing.assert_array_equal(by_key.theta_chain[q],
                                      by_int.theta_chain[q])


def test_chunking_changes_no_sample(capsys):
    """``progress_every`` (and ``verbose``) cut sampling into other chunks;
    the samples, latent states and acceptance are unchanged, and verbose
    prints the JAX driver's lines."""
    plain = run_small(m=10, burn_in=3, return_latent_state_est=True)
    capsys.readouterr()
    chunked = run_small(m=10, burn_in=3, return_latent_state_est=True,
                        progress_every=2, verbose=True)
    printed = capsys.readouterr().out
    for q in plain.theta_chain:
        np.testing.assert_array_equal(plain.theta_chain[q],
                                      chunked.theta_chain[q])
    np.testing.assert_array_equal(plain.latent_state_chain,
                                  chunked.latent_state_chain)
    assert plain.latent_state_chain.shape == (2, 7, len(Y) + 1)
    np.testing.assert_array_equal(plain.acceptance_rate,
                                  chunked.acceptance_rate)
    assert "Running pilot chains for tuning (2 chains)..." in printed
    assert "Running Particle MCMC chains with tuned settings..." in printed
    assert printed.count("Sampling: ") == 5
    assert "Sampling: 10/10 steps — acceptance chunk" in printed
    assert "[timing] tuning: " in printed


def test_burn_in_zero_keeps_the_pilot_mean_as_the_first_sample():
    out = run_small(m=5, burn_in=0, return_latent_state_est=True)
    assert out.theta_chain["a"].shape == (2, 5)
    assert out.latent_state_chain.shape == (2, 5, len(Y) + 1)


def test_single_chain_ess_message(capsys):
    out = run_small(num_chains=1, m=8, burn_in=2)
    assert "ESS cannot be computed with only one chain" in (
        capsys.readouterr().out)
    assert np.isnan(out.diagnostics["ess"]["a"])


def test_low_ess_warns_and_the_summary_prints(capsys):
    tune = default_tune_control(pilot_m=20, pilot_reps=3, pilot_n=50)
    with pytest.warns(UserWarning, match="ESS values are below 400"):
        out = pmmh(**_call(m=8, burn_in=2, seed=5, param_transform=TRANSFORM,
                           tune_control=tune, print_summary=True,
                           device="cpu"))
    assert capsys.readouterr().out.strip() == str(out)


def test_package_pmmh_is_callable_after_a_submodule_import():
    import bayesssm_tpu_torch
    import bayesssm_tpu_torch.pmmh.driver  # noqa: F401

    assert callable(bayesssm_tpu_torch.pmmh)
    with pytest.raises(ValueError, match="burn_in"):
        bayesssm_tpu_torch.pmmh(**_call(m=5, burn_in=5))


def test_small_sir_run_through_the_sweep():
    """``pf_impl=sir_sweep_pf_impl`` in both phases (the whole-sweep path's
    plain version on the CPU): finite samples, counts in [50, 1000]."""
    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=5)
    fns, log_priors, transform = sir_model(100, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh("bootstrap_filter", y, 8, *fns, log_priors,
                   {"lam": 0.4, "gamma": 0.25}, 2, num_chains=3,
                   param_transform=transform, seed=3,
                   tune_control=default_tune_control(pilot_m=10,
                                                     pilot_reps=4),
                   pf_impl=sir_sweep_pf_impl(100, 10), print_summary=False,
                   device="cpu")
    for arr in out.theta_chain.values():
        assert arr.shape == (3, 6) and np.isfinite(arr).all() and (
            arr > 0).all()
    assert ((out.target_n >= 50) & (out.target_n <= 1000)).all()


@pytest.mark.parametrize("pf_wrapper", ["auxiliary_filter",
                                        "resample_move_filter"])
def test_small_sir_apf_rmpf_run_on_both_paths(pf_wrapper):
    """APF and RMPF on SIR through the whole sweep (``pf_impl``) and
    through the engine: the same seed tunes each path, and the two paths
    give finite samples and counts in [50, 1000]. (The JAX driver vmaps its
    pilot, and a vmapped Pallas sweep or day-step draws the block stream,
    so the per-key comparison of the test above holds on the engine's
    threefry-only path; ``tests/test_torch_sweep.py`` and
    ``tests/test_torch_filter_core.py`` hold the SIR filters per key.)"""
    from bayesssm_tpu_torch.models.sir import (
        sir_aux_log_likelihood_fn,
        sir_move_fn,
    )

    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=4)
    fns, log_priors, transform = sir_model(100, 10,
                                           transition="gillespie_pallas")
    extra = (dict(aux_log_likelihood_fn=sir_aux_log_likelihood_fn)
             if pf_wrapper == "auxiliary_filter"
             else dict(move_fn=sir_move_fn(100)))
    for pf_impl in (sir_sweep_pf_impl(100, 10), None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = pmmh(pf_wrapper, y, 5, *fns, log_priors,
                       {"lam": 0.4, "gamma": 0.25}, 1, num_chains=2,
                       param_transform=transform, seed=3,
                       tune_control=default_tune_control(pilot_m=4,
                                                         pilot_reps=3),
                       pf_impl=pf_impl, print_summary=False, device="cpu",
                       **extra)
        for arr in out.theta_chain.values():
            assert arr.shape == (2, 4) and np.isfinite(arr).all() and (
                arr > 0).all()
        assert ((out.target_n >= 50) & (out.target_n <= 1000)).all()


def test_lgss_posterior_near_truth():
    """The analogue of ``tests/test_pmmh.py::test_lgss_posterior_near_truth``
    with the same tolerances, on eight chains of a shorter run."""
    _, y = simulate_lgss(7, t_val=40, a=0.7, sigma_x=0.8, sigma_y=0.4)
    out = run_small(m=120, burn_in=30, num_chains=8, seed=1405, y=y,
                    tune=dict(pilot_m=60, pilot_reps=30),
                    pilot_init_params=(INIT_PARAMS * 3)[:8])
    summ = out.summary()
    assert abs(summ["a"]["mean"] - 0.7) < 0.35
    assert abs(summ["sigma_x"]["mean"] - 0.8) < 0.5
    assert abs(summ["sigma_y"]["mean"] - 0.4) < 0.4
