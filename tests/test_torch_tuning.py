"""The port's pilot tuning (bayesssm_tpu_torch/pmmh/tuning.py) against the
JAX package's.

Every chain of the port's batched pilot is held to an UN-vmapped, jitted
JAX ``run_pilot_chain`` on the same key ``fold_in(key(3), c)``: LGSS
through the generic engine, 3 chains, pilot_m = 20, pilot_reps = 8.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.models.lgss import lgss_model as j_lgss_model
from bayesssm_tpu.pmmh.driver import _proposal_factor as j_proposal_factor
from bayesssm_tpu.pmmh.tuning import (
    _propose_until_valid as j_propose_until_valid,
    default_tune_control as j_default_tune_control,
    run_pilot_chain as j_run_pilot_chain,
)
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.pmmh.driver import chain_state_from_pilot
from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
from bayesssm_tpu_torch.pmmh.tuning import (
    MAX_PROPOSAL_TRIES,
    TuneControl,
    _make_pf_loglike,
    _propose_until_valid,
    default_tune_control,
    pilot_run,
    run_pilot_chain,
)

torch.set_num_threads(1)

MODEL_FNS, LOG_PRIORS, TRANSFORM = lgss_model()
NAMES = list(LOG_PRIORS)
PRIOR_FNS = [LOG_PRIORS[q] for q in NAMES]
TRANSFORMS = resolve_transforms(TRANSFORM, NAMES)
CONTROL = dict(pilot_m=20, pilot_reps=8)
THETA0 = np.array([[0.5, 0.5, 0.5], [0.8, 1.0, 0.8], [0.3, 0.7, 0.4]],
                  np.float32)
ROOT_SEED = 3


class TestDefaultTuneControl:
    def test_defaults(self):
        assert default_tune_control() == TuneControl(
            pilot_proposal_sd=0.5, pilot_n=100, pilot_m=2000,
            pilot_target_var=1.0, pilot_burn_in=500, pilot_reps=100,
            pilot_resample_algorithm="SISAR", pilot_resample_fn="stratified",
        )

    def test_valid_overrides(self):
        tc = default_tune_control(pilot_m=100, pilot_resample_fn="systematic")
        assert tc.pilot_m == 100
        assert tc.pilot_resample_fn == "systematic"

    @pytest.mark.parametrize("kw", [
        {"pilot_proposal_sd": -1.0},
        {"pilot_n": 0},
        {"pilot_m": -5},
        {"pilot_reps": 0},
        {"pilot_resample_algorithm": "XX"},
        {"pilot_resample_fn": "bogus"},
    ])
    def test_invalid_inputs_give_the_jax_message(self, kw):
        with pytest.raises(ValueError) as want:
            j_default_tune_control(**kw)
        with pytest.raises(ValueError) as got:
            default_tune_control(**kw)
        assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def pilots():
    """The port's batched pilot and one un-vmapped JAX pilot per chain."""
    _, y = simulate_lgss(1405, t_val=15)
    j_fns, j_priors, _ = j_lgss_model()
    j_control = j_default_tune_control(**CONTROL)
    j_fn = jax.jit(lambda k, th: j_run_pilot_chain(
        k, jnp.asarray(y), NAMES, (*j_fns, None, None),
        [j_priors[q] for q in NAMES], th, TRANSFORMS, j_control))
    root = jax.random.key(ROOT_SEED)
    jax_out = [
        {k: np.asarray(v) for k, v in j_fn(
            jax.random.fold_in(root, c), jnp.asarray(THETA0[c])).items()}
        for c in range(len(THETA0))
    ]
    keys = threefry.fold_in(threefry.key(ROOT_SEED),
                            torch.arange(len(THETA0)))
    port = run_pilot_chain(keys, y, NAMES, (*MODEL_FNS, None, None),
                           PRIOR_FNS, THETA0, TRANSFORMS,
                           default_tune_control(**CONTROL))
    return y, {k: v.numpy() for k, v in port.items()}, jax_out


@pytest.mark.parametrize("c", [0, 1, 2])
def test_run_pilot_chain_matches_jax_per_key(pilots, c):
    """Theta chain to 1e-5 and target_n exactly. The variance to 1e-5
    relative, or 1e-6 absolute where the variance is small: the engine's
    log-likelihoods agree with JAX's to an ulp or two (about 4e-6 at
    |ll| ~ 20, float32), and a variance of 0.036 over 8 reps moves by
    5e-7 under such a change."""
    _, port, jax_out = pilots
    want = jax_out[c]
    np.testing.assert_allclose(port["pilot_theta_chain"][c],
                               want["pilot_theta_chain"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["pilot_loglike_chain"][c],
                               want["pilot_loglike_chain"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(port["pilot_theta_mean"][c],
                               want["pilot_theta_mean"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["pilot_theta_cov"][c],
                               want["pilot_theta_cov"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(port["variance_estimate"][c],
                               want["variance_estimate"], rtol=1e-5,
                               atol=1e-6)
    assert port["target_n"][c] == want["target_n"]
    assert port["pilot_accept_rate"][c] == pytest.approx(
        float(want["pilot_accept_rate"]), abs=1e-6)


def test_the_pilots_cover_both_clamp_and_interior(pilots):
    """The per-key case is not trivial: one chain is tuned inside
    (50, 1000), the others at the floor."""
    _, port, _ = pilots
    assert sorted(port["target_n"].tolist()) == [50.0, 50.0, 331.0]


def test_chain_state_from_pilot_matches_the_jax_factors(pilots):
    """The delta-method proposal factors of the JAX driver
    (``driver.py:446-458``) from the JAX pilot outputs, to 1e-6."""
    _, _, jax_out = pilots
    mean = np.stack([o["pilot_theta_mean"] for o in jax_out]).astype(
        np.float64)
    cov = np.stack([o["pilot_theta_cov"] for o in jax_out]).astype(
        np.float64)
    target_n = np.stack([o["target_n"] for o in jax_out]).astype(np.int64)
    want = np.zeros_like(cov, dtype=np.float32)
    for c in range(len(mean)):
        scale = np.ones(len(NAMES))
        for j, t in enumerate(TRANSFORMS):
            if t == "log":
                scale[j] = 1.0 / mean[c, j]
            elif t == "logit":
                scale[j] = 1.0 / (mean[c, j] * (1.0 - mean[c, j]))
        want[c] = j_proposal_factor((scale[:, None] * cov[c])
                                    * scale[None, :])
    words = np.array([[1, 2], [3, 4], [2**32 - 1, 0]], np.uint32)
    state = chain_state_from_pilot(mean, cov, target_n, TRANSFORMS, words,
                                   "cpu")
    np.testing.assert_allclose(state.factors.numpy(), want, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(state.theta.numpy(),
                                  mean.astype(np.float32))
    np.testing.assert_array_equal(state.n.numpy(), target_n)
    np.testing.assert_array_equal(state.words.numpy(), words)
    assert state.ll is None


def test_propose_loop_falls_back_after_100_tries():
    """A prior that rejects everything: after MAX_PROPOSAL_TRIES tries the
    chain keeps its current theta (JAX's loop agrees)."""
    reject = [lambda v: torch.full_like(v, -np.inf)] * 3
    theta = torch.tensor([[0.5, 0.6, 0.7], [0.1, 0.2, 0.3]])
    keys = threefry.split(threefry.key(9)[None], 2)[0]
    z = torch.log(theta)
    got = _propose_until_valid(keys, z, 0.5, ("log",) * 3, reject, theta)
    assert MAX_PROPOSAL_TRIES == 100
    torch.testing.assert_close(got, theta, rtol=0, atol=0)
    j_reject = [lambda v: -jnp.inf] * 3
    want = j_propose_until_valid(
        jax.random.wrap_key_data(jnp.asarray(keys[0].numpy(), jnp.uint32)),
        jnp.log(jnp.asarray(theta[0].numpy())), 0.5, ("log",) * 3, j_reject,
        jnp.asarray(theta[0].numpy()))
    np.testing.assert_array_equal(np.asarray(want), theta[0].numpy())


def test_propose_loop_keeps_each_chains_first_valid_draw():
    """A prior that rejects about half of the proposals: each chain's
    result is the JAX loop's for its own key, to 1e-6."""
    half = [lambda v: torch.where(v > 0.5, 0.0, -np.inf)]
    j_half = [lambda v: jnp.where(v > 0.5, 0.0, -jnp.inf)]
    c = 16
    theta = torch.full((c, 1), 0.6)
    keys = threefry.split(threefry.key(4)[None], c)[0]
    got = _propose_until_valid(keys, theta, 0.5, ("identity",), half, theta)
    tries_differ = 0
    for k in range(c):
        want = j_propose_until_valid(
            jax.random.wrap_key_data(jnp.asarray(keys[k].numpy(),
                                                 jnp.uint32)),
            jnp.asarray(theta[k].numpy()), 0.5, ("identity",), j_half,
            jnp.asarray(theta[k].numpy()))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        first = threefry.normal(threefry.split(keys[k:k + 1])[:, 1], (1,))
        tries_differ += bool(0.6 + 0.5 * float(first) <= 0.5)
    assert float(got.min()) > 0.5
    assert tries_differ > 0            # some chains needed a second try


def test_pilot_run_in_chunks_draws_the_same_keys():
    """Rows through the filter in chunks give the unchunked result."""
    _, y = simulate_lgss(1405, t_val=8)
    control = default_tune_control(pilot_reps=5, pilot_n=50)
    pf = _make_pf_loglike(y, 50, NAMES, (*MODEL_FNS, None, None), None,
                          "BPF", "SISAR", "stratified", False,
                          max_particles=128)
    keys = threefry.split(threefry.key(2)[None], 3)[0]
    theta = torch.as_tensor(THETA0)
    whole = pilot_run(keys, theta, pf, control)
    chunked = pilot_run(keys, theta, pf, control, max_rows=4)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((whole[0] >= 50) & (whole[0] <= 1000)).all()


def test_pilot_run_maps_an_infinite_variance_to_the_cap():
    """-inf log-likelihoods give a NaN variance; target_n is 1000 (Q10)."""
    def pf(keys, theta):
        return torch.full((keys.shape[0],), -np.inf), None

    keys = threefry.split(threefry.key(0)[None], 2)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        target, var = pilot_run(keys, torch.zeros((2, 1)), pf,
                                default_tune_control(pilot_reps=4))
    assert target.tolist() == [1000.0, 1000.0]
    assert torch.isnan(var).all()
