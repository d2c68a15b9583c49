"""The port's ESS, split-R-hat, PMMHOutput, PhaseTimer and SSM against the
JAX package's.

All inputs come from numpy with a seed. ESS and R-hat agree with the JAX
functions to 1e-5 relative (both compute in float32; the sums and the FFT
run in another order); ``PMMHOutput.__str__`` agrees character for
character.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from bayesssm_tpu.diagnostics.ess import ess as j_ess
from bayesssm_tpu.diagnostics.rhat import rhat as j_rhat
from bayesssm_tpu.output import PMMHOutput as JPMMHOutput
from bayesssm_tpu.ssm import SSM as JSSM
from bayesssm_tpu_torch.diagnostics.ess import ess, ess_matrix
from bayesssm_tpu_torch.diagnostics.rhat import rhat, rhat_matrix
from bayesssm_tpu_torch.output import PMMHOutput
from bayesssm_tpu_torch.ssm import SSM
from bayesssm_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(1)

RTOL = 1e-5


def _ar1(rng, m, k, phi):
    x = np.zeros((m, k))
    x[0] = rng.normal(size=k)
    for t in range(1, m):
        x[t] = phi * x[t - 1] + rng.normal(size=k)
    return x


def _matrices():
    rng = np.random.default_rng(2024)
    return {
        "iid": rng.normal(size=(200, 4)),
        "ar1": _ar1(rng, 300, 3, 0.9),
        "odd_length": rng.normal(size=(101, 5)).astype(np.float32),
        "shifted": rng.normal(size=(80, 2)) + np.array([0.0, 3.0]),
        "short": rng.normal(size=(4, 2)),
        "f32_ar1": _ar1(rng, 257, 6, 0.5).astype(np.float32),
    }


MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("which", ["ess", "rhat"])
def test_matrix_input_matches_jax(name, which):
    mat = MATRICES[name]
    port, jax_fn = (ess, j_ess) if which == "ess" else (rhat, j_rhat)
    np.testing.assert_allclose(port(mat), jax_fn(mat), rtol=RTOL)


@pytest.mark.parametrize("which", ["ess", "rhat"])
def test_tensor_input_matches_array_input(which):
    mat = MATRICES["ar1"]
    fn = ess_matrix if which == "ess" else rhat_matrix
    got = fn(torch.as_tensor(mat))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == float(fn(mat))


def test_rhat_snaps_to_one_like_jax():
    """Values in [0.99, 1] become exactly 1.0."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        mat = rng.normal(size=(400, 4))
        want = j_rhat(mat)
        got = rhat(mat)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        if want == 1.0:
            assert got == 1.0
            break
    else:
        pytest.fail("no matrix snapped to 1.0")


@pytest.mark.parametrize("which", ["ess", "rhat"])
def test_zero_variance_gives_nan_and_warns(which):
    mat = MATRICES["iid"].copy()
    mat[:, 1] = 2.5
    port, jax_fn = (ess, j_ess) if which == "ess" else (rhat, j_rhat)
    with pytest.warns(UserWarning, match="zero variance"):
        got = port(mat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert np.isnan(jax_fn(mat))
    assert np.isnan(got)


@pytest.mark.parametrize("which", ["ess", "rhat"])
def test_dict_and_data_frame_input_match_jax(which):
    rng = np.random.default_rng(8)
    chains = {"a": rng.normal(size=(3, 120)),
              "b": _ar1(rng, 120, 3, 0.7).T}
    port, jax_fn = (ess, j_ess) if which == "ess" else (rhat, j_rhat)
    want = jax_fn(chains)
    got = port(chains)
    assert list(got) == list(want)
    for q in want:
        np.testing.assert_allclose(got[q], want[q], rtol=RTOL)
    frame = pd.DataFrame({"a": chains["a"].ravel(), "b": chains["b"].ravel(),
                          "chain": np.repeat([1, 2, 3], 120)})
    from_frame = port(frame)
    for q in want:
        assert from_frame[q] == got[q]


@pytest.mark.parametrize("bad,match", [
    (np.zeros((1, 3)), "iterations"),
    (np.zeros((5, 1)), "chains"),
    (np.zeros(5), "matrix"),
])
def test_ess_errors_match_jax(bad, match):
    with pytest.raises(ValueError) as want:
        j_ess(bad)
    with pytest.raises(ValueError, match=match) as got:
        ess(bad)
    assert str(got.value) == str(want.value)


def test_data_frame_errors_match_jax():
    no_chain = pd.DataFrame({"a": [1.0, 2.0]})
    uneven = pd.DataFrame({"a": [1.0, 2.0, 3.0], "chain": [1, 1, 2]})
    for frame in (no_chain, uneven):
        for port, jax_fn in ((ess, j_ess), (rhat, j_rhat)):
            with pytest.raises(ValueError) as want:
                jax_fn(frame)
            with pytest.raises(ValueError) as got:
                port(frame)
            assert str(got.value) == str(want.value)


def _outputs(seed, nan_diagnostics=False):
    rng = np.random.default_rng(seed)
    theta = {"lam": rng.gamma(5.0, 0.1, size=(4, 50)),
             "gamma": rng.gamma(2.0, 0.1, size=(4, 50)),
             "a_long_name": rng.normal(size=(4, 50)) * 100}
    diag = {"ess": {q: float(rng.uniform(10, 2000)) for q in theta},
            "rhat": {q: float(rng.uniform(0.99, 1.3)) for q in theta}}
    if nan_diagnostics:
        diag["ess"]["lam"] = float("nan")
        diag["rhat"]["gamma"] = float("nan")
        del diag["ess"]["a_long_name"]
    args = dict(theta_chain=theta, diagnostics=diag,
                acceptance_rate=rng.uniform(size=4),
                target_n=np.array([50, 60, 70, 80]), seed=seed)
    return PMMHOutput(**args), JPMMHOutput(**args)


@pytest.mark.parametrize("nan_diagnostics", [False, True])
def test_pmmh_output_prints_what_jax_prints(nan_diagnostics, capsys):
    port, want = _outputs(3, nan_diagnostics)
    assert str(port) == str(want)
    np.testing.assert_equal(port.summary(), want.summary())  # NaN == NaN
    assert port.print() is port
    assert capsys.readouterr().out == str(want) + "\n"
    pd.testing.assert_frame_equal(port.chains_dataframe(),
                                  want.chains_dataframe())
    pd.testing.assert_frame_equal(port.to_dataframe(), want.to_dataframe())
    assert port.param_names == want.param_names
    assert port.num_chains == want.num_chains == 4


def test_pmmh_output_round_trips_through_ess():
    port, _ = _outputs(4)
    frame = port.chains_dataframe()
    got = ess(frame)
    for q in port.param_names:
        np.testing.assert_allclose(got[q], j_ess(port.theta_chain[q].T),
                                   rtol=RTOL)


def test_phase_timer_accumulates_and_prints(capsys):
    timer = PhaseTimer(verbose=True, device="cpu")
    for _ in range(2):
        with timer.phase("tuning"):
            sum(range(1000))
    assert set(timer.timings) == {"tuning"}
    assert timer.timings["tuning"] > 0
    assert capsys.readouterr().out.count("[timing] tuning: ") == 2


def test_ssm_checks_like_jax():
    def init_fn(key, num_particles, a):
        return torch.zeros((key.shape[0], num_particles))

    def transition_fn(key, particles, a, sigma_x):
        return particles

    def log_likelihood_fn(y, particles, sigma_y):
        return particles * 0

    def bad_init(key):
        return None

    priors = {"a": None, "sigma_x": None, "sigma_y": None}
    params = {"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}
    port = SSM(init_fn, transition_fn, log_likelihood_fn)
    want = JSSM(init_fn, transition_fn, log_likelihood_fn)
    port.check_params_match(params, priors)
    want.check_params_match(params, priors)
    init, _, loglik, aux, move = port.adapted()
    assert aux is None and move is None
    assert init(key=torch.zeros((2, 2)), num_particles=3, a=1.0,
                t=4).shape == (2, 3)
    assert loglik(y=1.0, particles=torch.ones((2, 3)), sigma_y=1.0, a=1.0,
                  t=2).shape == (2, 3)
    for bad_params, bad_priors in (({"a": 0.5, "sigma_x": 0.5}, priors),
                                   (params, {"a": None})):
        with pytest.raises(ValueError) as j_err:
            want.check_params_match(bad_params, bad_priors)
        with pytest.raises(ValueError) as p_err:
            port.check_params_match(bad_params, bad_priors)
        assert str(p_err.value) == str(j_err.value)
    for cls in (SSM, JSSM):
        with pytest.raises(ValueError, match="num_particles"):
            cls(bad_init, transition_fn, log_likelihood_fn).adapted()
