"""README example on an NVIDIA GPU: PMMH on the sinusoidal AR(1) SSM.

The PyTorch port of ``examples/sinusoidal_readme.py``: simulate 20
observations with phi=0.8, sigma_x=1, sigma_y=0.5, then recover the
posterior with a bootstrap-filter PMMH (2 chains, pilot-tuned), the
reference README's call (m 500, burn-in 50, seed 1405, pilot_m 200).

Run: ``python examples/torch_sinusoidal_readme.py [--fused] [--device
cpu]``. ``--fused`` routes both PMMH phases through the model's
whole-sweep kernel (``sinusoidal_sweep_pf_impl``, one CUDA launch a
filter); without it the filter is the engine, whose weight step is the
fused resampling kernel. The default device is the current CUDA device;
``--device cpu`` runs the plain PyTorch versions instead.

``parity(out)`` holds a run to the reference README's posterior table
with the 3-SE bands of ``tests/test_parity.py`` (``README_ANCHOR``,
``se_bound``).
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bayesssm_tpu_torch import default_tune_control, pmmh  # noqa: E402
from bayesssm_tpu_torch.models.sinusoidal import (  # noqa: E402
    simulate_sinusoidal,
    sinusoidal_model,
    sinusoidal_sweep_pf_impl,
)

# (mean, sd, ess) of the reference README's run (BASELINE.md).
README_ANCHOR = {
    "phi": (0.76, 0.12, 8.0),
    "sigma_x": (0.78, 0.56, 15.0),
    "sigma_y": (0.89, 0.36, 36.0),
}


def se_bound(sd_ours, ess_ours, sd_ref, ess_ref, k=3.0):
    """k-SE band for the difference of two posterior means computed on
    independent datasets: both posterior SDs (the data-realization spread)
    plus both chains' Monte-Carlo errors, SD / sqrt(ESS)."""
    mcse_ours = sd_ours / np.sqrt(max(float(ess_ours), 1.0))
    mcse_ref = sd_ref / np.sqrt(max(float(ess_ref), 1.0))
    return k * np.sqrt(sd_ours**2 + sd_ref**2 + mcse_ours**2 + mcse_ref**2)


def parity(out) -> dict:
    """``{param: (mean, sd, ESS, |mean - anchor|, 3-SE bound)}`` of a
    README run against ``README_ANCHOR``."""
    summ = out.summary()
    rows = {}
    for param, (m_ref, sd_ref, ess_ref) in README_ANCHOR.items():
        s = summ[param]
        rows[param] = (s["mean"], s["sd"], s["ESS"], abs(s["mean"] - m_ref),
                       se_bound(s["sd"], s["ESS"], sd_ref, ess_ref))
    return rows


def main(m=500, burn_in=50, fused=False, device=None, tune_control=None):
    """The README's ``pmmh()`` call on ``device`` (default: the current
    CUDA device); ``tune_control`` defaults to the README's
    ``default_tune_control(pilot_m=200)``."""
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        sinusoidal_model()
    )
    _, y = simulate_sinusoidal(seed=1405, t_val=20)

    result = pmmh(
        "bootstrap_filter",
        y,
        m=m,
        pf_impl=sinusoidal_sweep_pf_impl() if fused else None,
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn,
        log_priors=log_priors,
        pilot_init_params=[
            {"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
            {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8},
        ],
        burn_in=burn_in,
        num_chains=2,
        seed=1405,
        param_transform=transform,
        tune_control=(tune_control if tune_control is not None
                      else default_tune_control(pilot_m=200)),
        verbose=True,
        device=device,
    )
    print("acceptance rates:", result.acceptance_rate)
    print("tuned particle counts:", result.target_n)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fused", action="store_true",
                        help="both phases through the whole-sweep kernel")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain versions; default: the "
                             "current CUDA device")
    args = parser.parse_args()
    main(fused=args.fused,
         device=None if args.device is None else torch.device(args.device))
