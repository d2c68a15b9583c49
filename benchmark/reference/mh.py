"""The random-walk Metropolis-Hastings step of PMMH, restated for a batch
of chains.

A proposal ``z' = z + L eps`` on the transformed scale (``log`` maps (0,
inf) to R, ``logit`` (0, 1) to R, ``identity`` nothing), the prior, the
log-Jacobian ``+log|d theta / d z|`` of every transform, and acceptance
when ``log(u) < log_ratio``; a proposal outside the prior's support or a
NaN ratio is rejected. Step ``s`` draws its filter words, normals and
accept uniform from the MH stream of ``lowbias.py``.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import lowbias

_CODE = {"identity": 0, "log": 1, "logit": 2}


def _codes(transforms, like):
    return torch.tensor([_CODE[t] for t in transforms], dtype=torch.int32,
                        device=like.device)


def transform(theta, transforms):
    code = _codes(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    logit = torch.log(safe) - torch.log1p(-torch.clamp(theta, max=1 - 1e-15))
    out = torch.where(code == 1, torch.log(safe), theta)
    return torch.where(code == 2, logit, out)


def back_transform(z, transforms):
    code = _codes(transforms, z)
    out = torch.where(code == 1, torch.exp(z), z)
    return torch.where(code == 2, 1.0 / (1.0 + torch.exp(-z)), out)


def log_jacobian(theta, transforms):
    code = _codes(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    log_term = torch.log(safe)
    logit_term = torch.log(safe) + torch.log1p(
        -torch.clamp(theta, max=1 - 1e-15))
    per = torch.where(code == 1, log_term, torch.where(
        code == 2, logit_term, torch.zeros_like(theta)))
    return per.sum(dim=-1)


def sum_log_priors(theta, prior_fns):
    total = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                        device=theta.device)
    for j, fn in enumerate(prior_fns):
        lp = fn(theta[..., j])
        total = total + torch.where(torch.isnan(lp), -math.inf, lp)
    return total


def mh_step(filt, words, step: int, theta, ll, factors, prior_fns,
            transforms):
    """MH step ``step`` of every chain from ``(theta [C, P], ll [C])``:
    ``filt(seed_words [C, 2], theta_prop) -> ll_prop [C]``. Returns
    ``(theta, ll, ll_prop)``."""
    p = theta.shape[1]
    w = lowbias.step_words(words, step, 3 + 2 * p)
    u = lowbias.word_uniform(w[:, 2:2 + 2 * p])
    eps = lowbias.box_muller(u[:, 0::2], u[:, 1::2]).to(theta.dtype)
    u_acc = lowbias.word_uniform(w[:, 2 + 2 * p]).to(theta.dtype)
    z = transform(theta, transforms)
    zp = z + (factors * eps[:, None, :]).sum(dim=-1)
    theta_prop = back_transform(zp, transforms)
    lp_prop = sum_log_priors(theta_prop, prior_fns)
    ll_prop = filt(w[:, :2], theta_prop).to(theta.dtype)
    log_ratio = (
        ll_prop + lp_prop + log_jacobian(theta_prop, transforms)
    ) - (ll + sum_log_priors(theta, prior_fns)
         + log_jacobian(theta, transforms))
    log_ratio = torch.where(
        torch.isnan(log_ratio) | ~torch.isfinite(lp_prop), -math.inf,
        log_ratio)
    accept = torch.log(u_acc) < log_ratio
    return (torch.where(accept[:, None], theta_prop, theta),
            torch.where(accept, ll_prop, ll), ll_prop)
