"""Prior evaluation shared by the PMMH chains (port of
``bayesssm_tpu/pmmh/priors.py``), batched over a leading chain axis."""

from __future__ import annotations

import math

import torch

__all__ = ["sum_log_priors"]


def sum_log_priors(theta: torch.Tensor, prior_fns) -> torch.Tensor:
    """Sum of per-parameter log-priors at ``theta [..., P]`` -> ``[...]``.

    ``prior_fns`` holds one log-density callable per parameter, in the
    order of the last axis. NaN from a user density means "outside the
    support" and becomes ``-inf``, which rejects the proposal.
    """
    total = torch.zeros(theta.shape[:-1], dtype=torch.float32,
                        device=theta.device)
    for j, fn in enumerate(prior_fns):
        lp = torch.as_tensor(fn(theta[..., j]), dtype=torch.float32,
                             device=theta.device)
        lp = torch.where(torch.isnan(lp), -math.inf, lp)
        total = total + lp
    return total
