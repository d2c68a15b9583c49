"""Log-density helpers for model and prior definitions.

PyTorch port of ``bayesssm_tpu/models/distributions.py``: the R ``d*``
functions (dnorm/dexp/dunif/dpois and extraDistr::dhnorm) as float32
log-densities that return ``-inf`` outside the support, which PMMH reads
as prior/support rejection. Scalar arguments are taken as float32, as the
JAX package's weakly typed Python floats are.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "norm_logpdf",
    "exp_logpdf",
    "unif_logpdf",
    "pois_logpmf",
    "halfnorm_logpdf",
    "beta_logpdf",
]

_F32 = torch.float32


def _t(v, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    if device is not None and isinstance(v, (int, float)):
        # A fill, not a copy from the host: no stream sync on a GPU.
        return torch.full((), float(v), dtype=_F32, device=device)
    return torch.as_tensor(v, dtype=_F32, device=device)


# float32 log(2 pi), as a Python float that converts back exactly.
_LOG_2PI = float(torch.log(torch.tensor(2.0 * math.pi, dtype=_F32)))


def norm_logpdf(x, mean=0.0, sd=1.0):
    """log N(x; mean, sd) — R's dnorm(log=TRUE)."""
    x = _t(x)
    z = (x - _t(mean, x)) / _t(sd, x)
    return -0.5 * (_LOG_2PI + z * z) - torch.log(_t(sd, x))


def exp_logpdf(x, rate=1.0):
    """log Exp(x; rate) — R's dexp(log=TRUE); -inf for x < 0."""
    x = _t(x)
    rate = _t(rate, x)
    return torch.where(
        x >= 0, torch.log(rate) - rate * x, _t(-math.inf, x)
    )


def unif_logpdf(x, lo=0.0, hi=1.0):
    """log Unif(x; lo, hi) — R's dunif(log=TRUE); -inf outside [lo, hi]."""
    x = _t(x)
    lo, hi = _t(lo, x), _t(hi, x)
    return torch.where(
        (x >= lo) & (x <= hi), -torch.log(hi - lo), _t(-math.inf, x)
    )


def pois_logpmf(k, rate):
    """log Pois(k; rate) — R's dpois(log=TRUE); rate == 0 puts all mass
    on k == 0 without NaNs."""
    rate = _t(rate)
    k = _t(k, rate)
    safe_rate = torch.where(rate > 0, rate, _t(1.0, rate))
    out = k * torch.log(safe_rate) - rate - torch.lgamma(k + 1.0)
    return torch.where(
        rate > 0, out,
        torch.where(k == 0, _t(0.0, rate), _t(-math.inf, rate)),
    )


def beta_logpdf(x, a=1.0, b=1.0):
    """log Beta(x; a, b) — R's dbeta(log=TRUE); -inf outside the open
    interval (0, 1)."""
    x = _t(x)
    a, b = _t(a, x), _t(b, x)
    inside = (x > 0) & (x < 1)
    xs = torch.where(inside, x, _t(0.5, x))
    out = (
        (a - 1.0) * torch.log(xs)
        + (b - 1.0) * torch.log1p(-xs)
        + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
    )
    return torch.where(inside, out, _t(-math.inf, x))


def halfnorm_logpdf(x, sigma=1.0):
    """log half-normal(x; sigma) — extraDistr::dhnorm(log=TRUE); -inf for
    x < 0 (the SIR vignette's priors)."""
    x = _t(x)
    sigma = _t(sigma, x)
    return torch.where(
        x >= 0,
        torch.log(_t(2.0, x)) - 0.5 * _LOG_2PI
        - torch.log(sigma) - 0.5 * (x / sigma) ** 2,
        _t(-math.inf, x),
    )
