"""Error contracts of the port's tuning control, ``pmmh()`` arguments and
diagnostics, the mirror of ``tests/test_error_contracts.py``'s
``TestTuneControlValidation``, ``TestPmmhArgumentValidation`` and
``TestDiagnosticsValidation``: each bad input raises the exception type
and message that the JAX function raises on the same call. Cases that
``tests/test_torch_pmmh.py::test_validation_messages_match_jax`` (m = 0,
burn_in = m, num_chains = 0, the chain count, NaN in y) or
``tests/test_torch_diagnostics.py`` (the ESS matrix shapes, a data frame
without a chain column for ``ess`` and ``rhat``) already hold are left to
them. The bootstrap-filter class is mirrored by
``tests/test_torch_filter_core.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.diagnostics.ess import ess as j_ess
from bayesssm_tpu.diagnostics.rhat import rhat as j_rhat
from bayesssm_tpu.pmmh.driver import pmmh as j_pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control as j_tune
from bayesssm_tpu_torch.diagnostics.ess import ess
from bayesssm_tpu_torch.diagnostics.rhat import rhat
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

torch.set_num_threads(1)


def same_error(port_call, jax_call):
    """Both calls raise; the port's exception has the JAX one's type and
    message."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    return got.value


TUNE_CASES = {
    "negative_proposal_sd": dict(pilot_proposal_sd=-0.1),
    "zero_pilot_n": dict(pilot_n=0),
    "negative_pilot_m": dict(pilot_m=-10),
    "bad_target_var": dict(pilot_target_var="a"),
    "negative_burn_in": dict(pilot_burn_in=-1),
    "bad_resample_algorithm": dict(pilot_resample_algorithm="InvalidAlg"),
    "bad_resample_fn": dict(pilot_resample_fn="InvalidFn"),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_control_validation(case):
    """test-pmmh.R:46-73."""
    kw = TUNE_CASES[case]
    same_error(lambda: default_tune_control(**kw), lambda: j_tune(**kw))


# The JAX test's model functions, in each library.
def _fns(lib):
    zeros = torch.zeros if lib == "port" else jnp.zeros

    def init_fn(key, num_particles):
        return zeros(num_particles)

    def transition_fn(key, particles):
        return particles

    def loglik_fn(y, particles):
        return zeros(particles.shape[0])

    return init_fn, transition_fn, loglik_fn


def _args(lib, over):
    init_fn, transition_fn, loglik_fn = _fns(lib)
    kw = dict(pf_wrapper="bootstrap_filter", y=np.zeros(10), m=10,
              init_fn=init_fn, transition_fn=transition_fn,
              log_likelihood_fn=loglik_fn,
              log_priors={"a": lambda v: 0.0},
              pilot_init_params={"a": 0.5}, burn_in=2, num_chains=2,
              print_summary=False)
    kw.update(over(lib) if callable(over) else over)
    return kw


def _trans_with(param):
    def make(lib):
        if param == "extra_param":
            def trans(key, particles, extra_param):
                return particles
        else:
            def trans(key, particles, a):
                return particles
        return dict(transition_fn=trans)
    return make


def _support_prior(lib):
    where = torch.where if lib == "port" else jnp.where

    def prior(v):
        return where(v > 0, 0.0, -np.inf)

    return dict(log_priors={"a": prior}, pilot_init_params={"a": -1.0})


def _non_numeric_y(lib):
    return dict(y="not numeric")


PMMH_CASES = {
    # test-pmmh.R:129-140 "Assertion on 'y' failed"
    "non_numeric_y": _non_numeric_y,
    # :142-153
    "negative_m": dict(m=-5),
    # :155-166
    "negative_burn_in": dict(burn_in=-1),
    # :194-205
    "loglik_missing_y": lambda lib: dict(
        log_likelihood_fn=lambda particles: particles),
    # :207-254
    "empty_pilot_init_params": dict(pilot_init_params={}),
    "pilot_init_params_mismatched_names": dict(
        pilot_init_params=[{"a": 0.5}, {"b": 0.5}]),
    # :275-289
    "init_missing_num_particles": lambda lib: dict(
        init_fn=lambda key: (torch.zeros if lib == "port"
                             else jnp.zeros)(8)),
    # :291-302
    "transition_missing_particles": lambda lib: dict(
        transition_fn=lambda key: 0.0),
    # :304-315
    "loglik_missing_particles": lambda lib: dict(
        log_likelihood_fn=lambda y: y),
    # :335-347
    "params_not_in_pilot_init": _trans_with("extra_param"),
    # :349-360
    "params_not_in_log_priors": lambda lib: dict(
        _trans_with("a")(lib), log_priors={"b": lambda v: 0.0}),
    # R/pmmh_tuning.R:135-143
    "out_of_support_init": _support_prior,
}


@pytest.mark.parametrize("case", sorted(PMMH_CASES))
def test_pmmh_argument_validation(case):
    """test-pmmh.R:126-360."""
    over = PMMH_CASES[case]
    err = same_error(lambda: pmmh(device="cpu", **_args("port", over)),
                     lambda: j_pmmh(**_args("jax", over)))
    assert isinstance(err, ValueError)


@pytest.mark.parametrize("fn,j_fn", [(ess, j_ess), (rhat, j_rhat)],
                         ids=["ess", "rhat"])
def test_diagnostics_reject_a_list(fn, j_fn):
    """test-ESS.R:35-75 / test-rhat.R:29-82."""
    err = same_error(lambda: fn([1, 2, 3]), lambda: j_fn([1, 2, 3]))
    assert "matrix or a" in str(err)
