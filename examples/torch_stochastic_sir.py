"""Stochastic SIR epidemic inference on an NVIDIA GPU: the vignette example.

The PyTorch port of ``examples/stochastic_sir.py``: a closed-population
continuous-time SIR model (500 people, 70 infected at the start) with
Poisson-observed infectious counts over 10 days. The transition is the
exact Gillespie jump process (``sir_model(transition="gillespie")``), so
each filter day runs the per-day event kernel and then the fused weight
step on the card. PMMH: 2 chains, m 1000, burn-in 200, pilot_m 100,
seed 1405.

Run: ``python examples/torch_stochastic_sir.py [--device cpu]`` (default:
the current CUDA device).
"""

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bayesssm_tpu_torch import default_tune_control, pmmh  # noqa: E402
from bayesssm_tpu_torch.models.sir import (  # noqa: E402
    simulate_sir,
    sir_model,
)


def main(m=1000, burn_in=200, device=None, tune_control=None):
    """The vignette's ``pmmh()`` call on ``device`` (default: the current
    CUDA device); ``tune_control`` defaults to the vignette's
    ``default_tune_control(pilot_m=100)``."""
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        sir_model(n_total=500, init_infected=70, transition="gillespie")
    )
    states, y = simulate_sir(seed=1405, lam=0.5, gamma=0.2)
    print("observed counts:", y)

    result = pmmh(
        "bootstrap_filter",
        y,
        m=m,
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn,
        log_priors=log_priors,
        pilot_init_params=[
            {"lam": 0.5, "gamma": 0.5},
            {"lam": 1.0, "gamma": 1.0},
        ],
        burn_in=burn_in,
        num_chains=2,
        seed=1405,
        param_transform=transform,
        tune_control=(tune_control if tune_control is not None
                      else default_tune_control(pilot_m=100)),
        verbose=True,
        device=device,
    )
    print("true lambda=0.5, gamma=0.2")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain versions; default: the "
                             "current CUDA device")
    args = parser.parse_args()
    main(device=None if args.device is None else torch.device(args.device))
