"""The plain reference on small SIR and sinusoidal cases: the same data,
priors, filters and MH step as the program's plain versions, bit for bit,
and its control (the reference in bfloat16) outside every cell's limits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import lowbias, mh, sinusoidal, sir, smc
from conftest import CELLS, PMMH_CELLS, tiny_cell

SIR_CFG = tiny_cell("sir.sweep").config
SIN_CFG = tiny_cell("sinusoidal.engine").config
C = 6


def _words(seed):
    return lowbias.chain_words(seed, C, "cpu")


def _theta(base, seed, sd=0.2):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((np.asarray(base) * np.exp(
        sd * rng.normal(size=(C, len(base))))).astype(np.float32))


def test_datasets_are_the_programs():
    from bayesssm_tpu_torch.models.sinusoidal import simulate_sinusoidal
    from bayesssm_tpu_torch.models.sir import simulate_sir

    np.testing.assert_array_equal(sir.simulate(SIR_CFG), simulate_sir(1405)[1])
    np.testing.assert_array_equal(sinusoidal.simulate(SIN_CFG),
                                  simulate_sinusoidal(1405, 20)[1])


def test_sir_sweep_is_the_programs_plain_sweep():
    from bayesssm_tpu_torch.models.sir import sir_sweep_pf_impl

    y = sir.simulate(SIR_CFG)
    pf = sir_sweep_pf_impl(500, 70)(y, 128, ["lam", "gamma"], None, None,
                                    "BPF", "SISAR", "stratified", False,
                                    max_particles=128)
    theta = _theta((0.5, 0.2), 3)
    n = torch.full((C,), 100.0)
    want, _ = pf(_words(5), theta, n)
    model = sir.Model(SIR_CFG)
    tally = smc.Tally()
    got = smc.sweep_filter(model, _words(5), model.sweep_obs(y, "cpu",
                           torch.float32), theta, n, 128, tally=tally)
    assert torch.equal(got, want)
    assert tally.fired > 0 and tally.chain_days == C * len(y)


@pytest.mark.parametrize("family", ["sir", "sinusoidal"])
def test_engine_is_the_programs_engine_with_its_fused_step(family,
                                                           card_paths):
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    if family == "sir":
        from bayesssm_tpu_torch.models.sir import sir_model

        cfg, ref, base = SIR_CFG, sir, (0.5, 0.2)
        fns = sir_model(500, 70, transition="gillespie_pallas")[0]
        names = ["lam", "gamma"]
    else:
        from bayesssm_tpu_torch.models.sinusoidal import sinusoidal_model

        cfg, ref, base = SIN_CFG, sinusoidal, (0.8, 1.0, 0.5)
        fns = sinusoidal_model()[0]
        names = ["phi", "sigma_x", "sigma_y"]
    y = ref.simulate(cfg)
    pf = _make_pf_loglike(y, 100, names, (*fns, None, None), None, "BPF",
                          "SISAR", "stratified", False, max_particles=128)
    theta = _theta(base, 4, 0.1)
    n = torch.full((C,), 100.0)
    want, _ = pf(_words(9), theta, n)
    model = ref.Model(cfg)
    got = smc.engine_filter(model, _words(9),
                            model.engine_obs(y, "cpu", torch.float32),
                            theta, n, 128)
    assert torch.equal(got, want)


def test_mh_step_is_the_programs():
    from bayesssm_tpu_torch.models.sir import sir_model
    from bayesssm_tpu_torch.pmmh.driver import mh_step, step_words
    from bayesssm_tpu_torch.ops.rng import box_muller

    priors = sir_model()[1]
    theta = _theta((0.5, 0.2), 7)
    ll = torch.linspace(-60.0, -40.0, C)
    factors = torch.as_tensor(np.tile(np.diag([0.1, 0.1]).astype(
        np.float32), (C, 1, 1)))
    words = _words(11)

    def filt(seed_words, th):
        return -50.0 + (seed_words[:, 0] % 7).to(torch.float32) - th.sum(1)

    got = mh.mh_step(filt, words, 3, theta, ll, factors, sir.log_priors(),
                     ("log", "log"))
    w = step_words(words, 3, 7)
    u = (w[:, 2:6] >> 8).to(torch.float32) * 2.0 ** -24
    want = mh_step(lambda sw, th, n: (filt(sw, th), None), theta, ll,
                   factors, None, box_muller(u[:, 0::2], u[:, 1::2]),
                   (w[:, 6] >> 8).to(torch.float32) * 2.0 ** -24, w[:, :2],
                   [priors["lam"], priors["gamma"]], ("log", "log"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", CELLS + PMMH_CELLS)
def test_control_in_bfloat16_breaks_a_limit(name, card_paths):
    cell = tiny_cell(name)
    driver = cell.driver()
    loop = driver.setup(cell, 2**40 + 3, torch.device("cpu"))
    driver.window(loop, 0.0, False)
    driver.release(loop)
    sound, _ = driver.check(loop)
    control = driver.control(loop, torch.bfloat16)
    limits = cell.workload["limits"]
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(not control[k] <= limits[k] for k in limits)
