"""Weight-normalization primitives for SMC (port of
``bayesssm_tpu/ops/weights.py``): max-shifted log-sum-exp normalization,
the per-step likelihood increment and the inverse-sum-of-squares ESS.

``axis_name`` names a mesh axis the particle dimension is sharded over
(``parallel/collectives.py``): the local reductions are then completed
over its shards, as the JAX functions complete them with ``pmax`` and
``psum``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "DEGENERATE_LOG_WEIGHT",
    "normalize_log_weights",
    "effective_sample_size",
    "log_mean_exp",
]

# All log-weights below this (after masking) mark a dead filter, the
# reference's degenerate-weight early exit.
DEGENERATE_LOG_WEIGHT = -1.0e8


def normalize_log_weights(log_weights: torch.Tensor, dim: int = -1,
                          axis_name: str | None = None):
    """``(weights, log_sum_exp_shifted, max_logw)``.

    ``max_logw + log_sum_exp_shifted`` is ``logsumexp(log_weights)``.
    ``-inf`` lanes get zero weight; an all ``-inf`` slice gives zero
    weights and a ``-inf`` log-sum-exp instead of NaN. With ``axis_name``
    the maximum and the sum are over every shard's lanes, so the pieces
    are global and the likelihood increment is the unsharded one.
    """
    max_logw = torch.amax(log_weights, dim=dim, keepdim=True)
    if axis_name is not None:
        from bayesssm_tpu_torch.parallel.collectives import pmax

        max_logw = pmax(max_logw, axis_name)
    safe_max = torch.where(torch.isfinite(max_logw), max_logw,
                           torch.zeros_like(max_logw))
    unnorm = torch.exp(log_weights - safe_max)
    wsum = torch.sum(unnorm, dim=dim, keepdim=True)
    if axis_name is not None:
        from bayesssm_tpu_torch.parallel.collectives import psum

        wsum = psum(wsum, axis_name)
    pos = wsum > 0.0
    one = torch.ones_like(wsum)
    weights = torch.where(pos, unnorm / torch.where(pos, wsum, one),
                          torch.zeros_like(unnorm))
    lse = torch.log(torch.where(pos, wsum, one))
    lse = torch.where(pos, lse, torch.full_like(lse, -math.inf))
    return weights, lse.squeeze(dim), max_logw.squeeze(dim)


def log_mean_exp(log_values: torch.Tensor, num, dim: int = -1):
    """``logsumexp(log_values) - log(num)``: one step's likelihood
    increment; ``num`` may be a per-chain particle count tensor."""
    _, lse, max_logw = normalize_log_weights(log_values, dim=dim)
    num = torch.as_tensor(num, dtype=torch.float32, device=lse.device)
    return max_logw + lse - torch.log(num)


def effective_sample_size(weights: torch.Tensor, dim: int = -1,
                          axis_name: str | None = None):
    """ESS = 1 / sum(w^2); an all-zero slice gives 0 rather than inf.
    ``axis_name`` completes the sum over a sharded particle axis."""
    denom = torch.sum(weights * weights, dim=dim)
    if axis_name is not None:
        from bayesssm_tpu_torch.parallel.collectives import psum

        denom = psum(denom, axis_name)
    pos = denom > 0.0
    return torch.where(
        pos, 1.0 / torch.where(pos, denom, torch.ones_like(denom)),
        torch.zeros_like(denom),
    )
