"""Parameter transforms for random-walk proposals.

Port of ``bayesssm_tpu/pmmh/transforms.py``: ``log`` maps (0, inf) to R,
``logit`` maps (0, 1) to R, ``identity`` is a no-op. ``theta`` carries the
parameters on its last axis, so a ``[C, P]`` batch of chains goes through
one call.

Jacobian conventions (quirk Q1): ``"consistent"`` uses +log|d theta/d z|
for every transform (log -> log(theta); logit -> log(theta (1 - theta)));
``"reference"`` reproduces the reference package's mixed convention, whose
logit term is -log(theta (1 - theta)).
"""

from __future__ import annotations

import warnings

import torch

from bayesssm_tpu_torch.utils.timing import host_sync

__all__ = [
    "TRANSFORMS",
    "resolve_transforms",
    "transform_params",
    "back_transform_params",
    "log_jacobian",
]

TRANSFORMS = ("identity", "log", "logit")
_CODE = {"identity": 0, "log": 1, "logit": 2}


def resolve_transforms(param_transform, param_names) -> tuple:
    """A user transform spec as a per-parameter tuple of names.

    ``None`` -> all identity; a dict must cover every parameter; invalid
    entries degrade to identity with a warning; the result follows
    ``param_names``.
    """
    if param_transform is None:
        return tuple("identity" for _ in param_names)
    if not isinstance(param_transform, dict):
        raise ValueError("param_transform must be a dict.")
    if any(p not in param_transform for p in param_names):
        raise ValueError(
            "param_transform must include an entry for every parameter in "
            "log_priors."
        )
    out = []
    invalid = False
    for p in param_names:
        t = param_transform[p]
        if t not in TRANSFORMS:
            invalid = True
            t = "identity"
        out.append(t)
    if invalid:
        warnings.warn(
            "Only 'log', 'logit', and 'identity' transformations are "
            "supported. Using 'identity' for invalid entries."
        )
    return tuple(out)


def _codes(transforms, like: torch.Tensor) -> torch.Tensor:
    # A copy from host memory: on a CUDA device the host waits for the
    # stream's queued work before it.
    host_sync(like)
    return torch.tensor([_CODE[t] for t in transforms], dtype=torch.int32,
                        device=like.device)


def transform_params(theta: torch.Tensor, transforms) -> torch.Tensor:
    """theta -> z on the proposal scale."""
    code = _codes(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    logit = torch.log(safe) - torch.log1p(-torch.clamp(theta, max=1 - 1e-15))
    out = torch.where(code == 1, torch.log(safe), theta)
    return torch.where(code == 2, logit, out)


def back_transform_params(z: torch.Tensor, transforms) -> torch.Tensor:
    """z -> theta on the model scale."""
    code = _codes(transforms, z)
    out = torch.where(code == 1, torch.exp(z), z)
    return torch.where(code == 2, 1.0 / (1.0 + torch.exp(-z)), out)


def log_jacobian(theta: torch.Tensor, transforms,
                 convention: str = "consistent") -> torch.Tensor:
    """Sum over the last axis of the per-parameter log-Jacobian terms."""
    if convention not in ("consistent", "reference"):
        raise ValueError("convention must be 'consistent' or 'reference'")
    code = _codes(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    log_term = torch.log(safe)
    logit_term = torch.log(safe) + torch.log1p(
        -torch.clamp(theta, max=1 - 1e-15)
    )
    if convention == "reference":
        logit_term = -logit_term
    per_param = torch.where(
        code == 1, log_term,
        torch.where(code == 2, logit_term, torch.zeros_like(theta)),
    )
    return per_param.sum(dim=-1)
