"""Whole-sweep kernels for YOUR model, on an NVIDIA GPU: the sweep builder.

The PyTorch port of ``examples/custom_sweep_kernel.py``. The fastest path
of the port runs the ENTIRE particle filter in one CUDA kernel (K1,
``bayesssm_tpu_torch/csrc/sweep.cuh``). ``build_sweep_pf_impl`` makes that
available for any model with float state columns: write three small
callbacks in ``torch`` (elementwise ops only: they are traced once into
the kernel, see ``bayesssm_tpu_torch/ops/sweep_codegen.py``) and get a
``pf_impl`` for ``pmmh``. On the card the callbacks become a generated
C++ functor, compiled by ``nvcc`` at the first call; on the CPU the same
callbacks run as the plain sweep.

Here: the stochastic-volatility model, which has no hand-written functor.

Run: ``python examples/torch_custom_sweep_kernel.py`` (the current CUDA
device) or ``python examples/torch_custom_sweep_kernel.py --device cpu``.
The chain is kept demo-short: expect the R-hat warning; SV posteriors
need longer series and chains than a minutes-long example affords.
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
from bayesssm_tpu_torch.ops.sweep_builder import (  # noqa: E402
    build_sweep_pf_impl,
)

HALF_LOG_2PI = 0.5 * np.log(2.0 * np.pi)


# --- the three callbacks: the model, written for the kernel ---------
# Contract (ops/sweep_builder.py docstring): every state column and every
# rng.normal()/rng.uniform() is a [C, N] float32 tensor; theta is a tuple
# of per-chain parameter broadcasts ordered as param_names below.

def sv_init(rng, theta):
    phi, sigma, mu = theta
    sd0 = sigma / torch.sqrt(1.0 - phi * phi)
    return (mu + sd0 * rng.normal(),)


def sv_transition(rng, cols, theta, t):
    phi, sigma, mu = theta
    return (mu + phi * (cols[0] - mu) + sigma * rng.normal(),)


def sv_log_weight(cols, theta, y_t):
    x = cols[0]
    return -HALF_LOG_2PI - 0.5 * x - 0.5 * y_t * y_t * torch.exp(-x)


def sv_pf_impl():
    """The ``pf_impl`` of the SV callbacks above."""
    return build_sweep_pf_impl(
        num_state_cols=1,
        init_fn=sv_init,
        transition_fn=sv_transition,
        log_weight_fn=sv_log_weight,
        param_names=("phi", "sigma", "mu"),
    )


def main(m=300, device=None):
    """The example's ``pmmh()`` call with ``m`` iterations (burn-in a
    quarter of them) on ``device`` (default: the current CUDA device)."""
    _, y = simulate_sv(seed=7, t_val=40, phi=0.95, sigma=0.3, mu=-1.0)

    # The driver still wants the portable model functions for signature
    # validation (and they remain the reference the kernel is tested
    # against).
    (init_fn, trans_fn, loglik_fn), log_priors, transform = sv_model()

    out = pmmh(
        "bootstrap_filter", np.asarray(y, np.float32), m,
        init_fn, trans_fn, loglik_fn, log_priors,
        pilot_init_params=[
            {"phi": 0.9, "sigma": 0.5, "mu": -0.5},
            {"phi": 0.95, "sigma": 0.2, "mu": -1.5},
        ],
        burn_in=m // 4, num_chains=2, seed=1405, param_transform=transform,
        tune_control=default_tune_control(
            pilot_m=max(m // 2, 4), pilot_burn_in=max(m * 2 // 15, 1),
            pilot_reps=10
        ),
        pf_impl=sv_pf_impl(),
        print_summary=True,
        device=device,
    )
    s = out.summary()
    print(
        "\nposterior means:",
        {p: round(s[p]["mean"], 3) for p in ("phi", "sigma", "mu")},
        "(truth: phi=0.95 sigma=0.3 mu=-1.0)",
    )
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain sweep; default: the "
                             "current CUDA device")
    parser.add_argument("--m", type=int, default=300)
    args = parser.parse_args()
    main(args.m, None if args.device is None else torch.device(args.device))
