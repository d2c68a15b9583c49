"""Multi-chain effective sample size (port of
``bayesssm_tpu/diagnostics/ess.py``, Vehtari et al. 2021).

The same conventions as the JAX function: between- and within-chain
variances, per-chain autocorrelations by FFT (padded to ``_next_pow2``)
combined as ``rho_t = 1 - (W - mean(s_i^2 rho_it)) / var_plus``, and
Geyer's initial monotone positive pairs. Everything is float32, as in the
JAX package, on the device of the input tensor (a NumPy array goes to
the CPU).

Input conventions:
  * a ``[iterations, chains]`` matrix -> scalar ESS;
  * a dict of ``param -> [chains, iterations]`` arrays, or a long data
    frame (a ``chain`` column plus one column per parameter) -> dict of
    ESS.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

__all__ = ["ess", "ess_matrix", "long_dataframe_to_dict"]


def _next_pow2(n: int) -> int:
    return 1 << (2 * n - 1).bit_length()


def _as_matrix(mat) -> torch.Tensor:
    """A float32 tensor of ``mat`` (a tensor keeps its device)."""
    if isinstance(mat, torch.Tensor):
        return mat.to(torch.float32)
    return torch.as_tensor(np.asarray(mat), dtype=torch.float32)


def _chain_vars(mat: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Per-column variance with ddof = 1, mean first (``jnp.var``)."""
    xc = mat - means
    return (xc * xc).sum(dim=0) / (mat.shape[0] - 1)


def _acf_fft(x: torch.Tensor) -> torch.Tensor:
    """Per-chain autocorrelation to lag m-1. ``x``: [m, k] -> [m, k].

    R's ``acf``: c_t = (1/m) sum_s (x_s - xbar)(x_{s+t} - xbar),
    rho_t = c_t / c_0.
    """
    m = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    nfft = _next_pow2(m)
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    ac = torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[:m]
    return ac / ac[0:1]


def ess_matrix(mat) -> torch.Tensor:
    """ESS of a ``[iterations, chains]`` matrix as a 0-d float32 tensor;
    NaN when any chain has zero variance (``ess`` also warns)."""
    mat = _as_matrix(mat)
    m, k = mat.shape
    chain_means = mat.mean(dim=0)
    overall = chain_means.mean()
    b = m / (k - 1) * ((chain_means - overall) ** 2).sum()
    chain_vars = _chain_vars(mat, chain_means)
    w = chain_vars.mean()
    var_hat = (m - 1) / m * w + b / m

    rho = _acf_fft(mat)
    term = (chain_vars[None, :] * rho).mean(dim=1)
    hat_rho = 1.0 - (w - term) / var_hat

    # Geyer pairs P_t = rho[2t-1] + rho[2t], t = 1..floor((m-1)/2), made
    # monotone non-increasing and summed up to the first negative one.
    max_pairs = (m - 1) // 2
    if max_pairs >= 1:
        pairs = hat_rho[1:2 * max_pairs + 1].reshape(max_pairs, 2).sum(dim=1)
        pairs = torch.cummin(pairs, dim=0).values
        nonneg = torch.cumprod((pairs >= 0).to(pairs.dtype), dim=0)
        sum_rho = (pairs * nonneg).sum()
    else:
        sum_rho = torch.zeros((), dtype=mat.dtype, device=mat.device)

    tau = 1.0 + 2.0 * sum_rho
    out = (k * m) / tau
    return torch.where((chain_vars == 0).any(),
                       torch.full_like(out, math.nan), out)


def _check_matrix(mat) -> None:
    m, k = mat.shape
    if m < 2:
        raise ValueError("Number of iterations must be at least 2.")
    if k < 2:
        raise ValueError("Number of chains must be at least 2.")


def _warn_if_nan(value: float) -> float:
    if np.isnan(value):
        warnings.warn("One or more chains have zero variance.")
    return value


def long_dataframe_to_dict(df):
    """The long data-frame layout (a ``chain`` column and one column per
    parameter) as ``{param: [chains, iterations]}``, with the JAX
    function's errors."""
    if "chain" not in df.columns:
        raise ValueError("Data frame must contain a 'chain' column.")
    param_cols = [c for c in df.columns if c != "chain"]
    chain_ids = df["chain"].unique()
    out = {}
    for param in param_cols:
        per_chain = [
            np.asarray(df[param][df["chain"] == cid]) for cid in chain_ids
        ]
        if len({len(v) for v in per_chain}) != 1:
            raise ValueError(
                "Not all chains have the same number of iterations."
            )
        out[param] = np.stack(per_chain, axis=0)
    return out


def _is_dataframe(obj) -> bool:
    return hasattr(obj, "columns") and hasattr(obj, "__getitem__")


def _param_matrices(chains) -> dict:
    """``{param: [iterations, chains]}`` from dict or data-frame input."""
    if _is_dataframe(chains):
        chains = long_dataframe_to_dict(chains)
    out = {}
    for param, arr in chains.items():
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError(
                f"chains for parameter {param!r} must be 2-D "
                "[chains, iterations]"
            )
        out[param] = arr.T
    return out


def _matrix(chains):
    mat = chains if isinstance(chains, torch.Tensor) else np.asarray(chains)
    if mat.ndim != 2:
        raise ValueError(
            "Input must be a matrix or a data frame with a 'chain' column "
            "(or a dict of [chains, iterations] arrays)."
        )
    return mat


def ess(chains):
    """Effective sample size of MCMC chains: a ``[iterations, chains]``
    matrix gives a float; a dict of ``param -> [chains, iterations]``
    arrays or a long data frame gives a dict of floats."""
    if _is_dataframe(chains) or isinstance(chains, dict):
        out = {}
        for param, mat in _param_matrices(chains).items():
            _check_matrix(mat)
            out[param] = _warn_if_nan(float(ess_matrix(mat)))
        return out
    mat = _matrix(chains)
    _check_matrix(mat)
    return _warn_if_nan(float(ess_matrix(mat)))
