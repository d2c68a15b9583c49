"""The port's examples on the CPU (``main(device="cpu", ...)``) at a cut
m and pilot: ``examples/torch_sinusoidal_readme.py`` on both routes,
``examples/torch_stochastic_sir.py`` and
``examples/torch_stochastic_volatility.py``. The card runs them at their
own settings (``chip_smoke.py`` phase 29).
"""

import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch import default_tune_control

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CUT = dict(m=12, burn_in=2)
CUT_TUNE = dict(pilot_m=10, pilot_burn_in=2, pilot_reps=4)


def load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,kw,params", [
    ("torch_sinusoidal_readme", dict(fused=True),
     ("phi", "sigma_x", "sigma_y")),
    ("torch_sinusoidal_readme", dict(fused=False),
     ("phi", "sigma_x", "sigma_y")),
    ("torch_stochastic_sir", {}, ("lam", "gamma")),
    ("torch_stochastic_volatility", {}, ("phi", "sigma", "mu")),
])
def test_example_runs_on_the_cpu(name, kw, params, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = load(name).main(device="cpu",
                              tune_control=default_tune_control(**CUT_TUNE),
                              **CUT, **kw)
    assert tuple(out.theta_chain) == params
    for q in params:
        assert out.theta_chain[q].shape == (2, CUT["m"] - CUT["burn_in"])
        assert np.isfinite(out.theta_chain[q]).all()
    assert ((out.acceptance_rate >= 0) & (out.acceptance_rate <= 1)).all()
    assert "PMMH Results Summary:" in capsys.readouterr().out
