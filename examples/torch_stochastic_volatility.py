"""Stochastic-volatility PMMH on an NVIDIA GPU.

The PyTorch port of ``examples/stochastic_volatility.py``. It fits the SV
model (Andrieu, Doucet & Holenstein 2010, §3.2)

    x_t = mu + phi (x_{t-1} - mu) + sigma eta_t,   y_t ~ N(0, exp(x_t))

to a simulated volatility path (T = 100, phi 0.95, sigma 0.3, mu -1.0)
with a bootstrap-filter PMMH: ``phi`` is proposed in logit space and
``sigma`` in log space. The filter is the engine, whose weight step is the
fused resampling kernel on the card. PMMH: 2 chains, m 500, burn-in 100,
seed 7, pilot_m 500 (burn-in 100, 20 repetitions).

Run: ``python examples/torch_stochastic_volatility.py [--device cpu]``
(default: the current CUDA device).
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bayesssm_tpu_torch import default_tune_control, pmmh  # noqa: E402
from bayesssm_tpu_torch.models.stochastic_volatility import (  # noqa: E402
    simulate_sv,
    sv_model,
)


def main(m=500, burn_in=100, device=None, tune_control=None):
    """The example's ``pmmh()`` call on ``device`` (default: the current
    CUDA device); ``tune_control`` defaults to the example's
    ``default_tune_control(pilot_m=500, pilot_burn_in=100,
    pilot_reps=20)``."""
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        sv_model()
    )
    x, y = simulate_sv(seed=1405, t_val=100, phi=0.95, sigma=0.3, mu=-1.0)
    print(f"simulated T={len(y)} observations; "
          f"log-vol mean {x.mean():.2f}, sd {x.std():.2f}")

    result = pmmh(
        "bootstrap_filter",
        np.asarray(y, np.float32),
        m=m,
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn,
        log_priors=log_priors,
        pilot_init_params=[
            {"phi": 0.9, "sigma": 0.5, "mu": 0.0},
            {"phi": 0.8, "sigma": 0.2, "mu": -2.0},
        ],
        burn_in=burn_in,
        num_chains=2,
        seed=7,
        param_transform=transform,
        tune_control=(tune_control if tune_control is not None
                      else default_tune_control(pilot_m=500,
                                                pilot_burn_in=100,
                                                pilot_reps=20)),
        device=device,
    )
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain versions; default: the "
                             "current CUDA device")
    args = parser.parse_args()
    main(device=None if args.device is None else torch.device(args.device))
