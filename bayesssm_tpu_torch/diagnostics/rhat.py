"""Split-R-hat convergence diagnostic (port of
``bayesssm_tpu/diagnostics/rhat.py``, Gelman et al. 2013).

The JAX function's conventions: drop the last iteration if the count is
odd, split each chain in half, ``sqrt(var_plus / W)`` with the full
(post-drop) iteration count ``m`` in both scalings, values in [0.99, 1]
snapped to 1.0, and NaN when a half-chain has zero variance. float32 on
the device of the input tensor, as :mod:`.ess`.
"""

from __future__ import annotations

import math

import torch

from bayesssm_tpu_torch.diagnostics.ess import (
    _as_matrix,
    _chain_vars,
    _is_dataframe,
    _matrix,
    _param_matrices,
    _warn_if_nan,
)

__all__ = ["rhat", "rhat_matrix"]


def rhat_matrix(mat) -> torch.Tensor:
    """Split-R-hat of a ``[iterations, chains]`` matrix as a 0-d float32
    tensor."""
    mat = _as_matrix(mat)
    m, k = mat.shape
    if m % 2 == 1:
        mat = mat[:-1]
        m -= 1
    half = m // 2
    # [half, 2k]: each chain split into its first and second half.
    split = torch.cat([mat[:half], mat[half:]], dim=1)
    chain_means = split.mean(dim=0)
    overall = chain_means.mean()
    b = m / (2 * k - 1) * ((chain_means - overall) ** 2).sum()
    chain_vars = _chain_vars(split, chain_means)
    w = chain_vars.mean()
    var_hat = (m - 1) / m * w + b / m
    r = torch.sqrt(var_hat / w)
    r = torch.where((r >= 0.99) & (r <= 1.0), torch.ones_like(r), r)
    return torch.where((chain_vars == 0).any(),
                       torch.full_like(r, math.nan), r)


def _compute(mat) -> float:
    if mat.shape[0] < 2:
        raise ValueError("Number of iterations must be at least 2.")
    return _warn_if_nan(float(rhat_matrix(mat)))


def rhat(chains):
    """Split-R-hat of MCMC chains; the inputs of :func:`.ess.ess`."""
    if _is_dataframe(chains) or isinstance(chains, dict):
        return {param: _compute(mat)
                for param, mat in _param_matrices(chains).items()}
    return _compute(_matrix(chains))
