"""Parameter transforms for random-walk proposals.

Port of ``bayesssm_tpu/pmmh/transforms.py``: ``log`` maps (0, inf) to R,
``logit`` maps (0, 1) to R, ``identity`` is a no-op. ``theta`` carries the
parameters on its last axis, so a ``[C, P]`` batch of chains goes through
one call.

Jacobian conventions (quirk Q1): ``"consistent"`` uses +log|d theta/d z|
for every transform (log -> log(theta); logit -> log(theta (1 - theta)));
``"reference"`` reproduces the reference package's mixed convention, whose
logit term is -log(theta (1 - theta)).

The per-parameter masks (``log``, ``logit``) are constants of a call: they
are copied to a device once per ``(transforms, device)``, the first time
that pair is seen, and reused from then on, so a step copies nothing from
the host and never waits for the device's queue. ``transform_consts.build``
and ``transform_consts.hit`` count the two cases.
"""

from __future__ import annotations

import warnings

import torch

from bayesssm_tpu_torch.utils.timing import count, host_sync

__all__ = [
    "TRANSFORMS",
    "resolve_transforms",
    "transform_params",
    "back_transform_params",
    "log_jacobian",
]

TRANSFORMS = ("identity", "log", "logit")
_CODE = {"identity": 0, "log": 1, "logit": 2}
# (transforms, device) -> (is_log, is_logit), two [P] bool tensors there.
_MASKS: dict = {}


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


def _masks(transforms, like: torch.Tensor) -> tuple:
    """The ``log`` and ``logit`` masks of ``transforms`` on ``like``'s
    device, built on the pair's first use (module docstring)."""
    key = (tuple(transforms), like.device)
    masks = _MASKS.get(key)
    if masks is not None:
        count("transform_consts.hit")
        return masks
    code = [_CODE[t] for t in key[0]]
    # A copy from host memory: on a CUDA device the host waits for the
    # stream's queued work before it, once per key.
    host_sync(like)
    masks = _MASKS[key] = torch.tensor(
        [[c == 1 for c in code], [c == 2 for c in code]], dtype=torch.bool,
        device=like.device).unbind(0)
    count("transform_consts.build")
    return masks


def transform_params(theta: torch.Tensor, transforms) -> torch.Tensor:
    """theta -> z on the proposal scale."""
    is_log, is_logit = _masks(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    logit = torch.log(safe) - torch.log1p(-torch.clamp(theta, max=1 - 1e-15))
    out = torch.where(is_log, torch.log(safe), theta)
    return torch.where(is_logit, logit, out)


def back_transform_params(z: torch.Tensor, transforms) -> torch.Tensor:
    """z -> theta on the model scale."""
    is_log, is_logit = _masks(transforms, z)
    out = torch.where(is_log, torch.exp(z), z)
    return torch.where(is_logit, 1.0 / (1.0 + torch.exp(-z)), out)


def log_jacobian(theta: torch.Tensor, transforms,
                 convention: str = "consistent") -> torch.Tensor:
    """Sum over the last axis of the per-parameter log-Jacobian terms."""
    if convention not in ("consistent", "reference"):
        raise ValueError("convention must be 'consistent' or 'reference'")
    is_log, is_logit = _masks(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    log_term = torch.log(safe)
    logit_term = torch.log(safe) + torch.log1p(
        -torch.clamp(theta, max=1 - 1e-15)
    )
    if convention == "reference":
        logit_term = -logit_term
    per_param = torch.where(
        is_log, log_term,
        torch.where(is_logit, logit_term, torch.zeros_like(theta)),
    )
    return per_param.sum(dim=-1)
