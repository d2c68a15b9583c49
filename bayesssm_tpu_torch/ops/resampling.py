"""Inverse-CDF resampling over a chain batch (port of
``bayesssm_tpu/ops/resampling.py``).

``cumsum -> positions -> searchsorted -> gather`` on ``[C, N]`` tensors,
for the three schemes of the reference's C++ resamplers:

* multinomial — iid positions ``u_j ~ U[0, 1)``;
* stratified  — one draw per stratum, ``(j + U_j) / n``;
* systematic  — one shared offset, ``(j + U) / n``.

The ancestor of slot ``j`` is ``min{i : cdf_i >= u_j}``: a lower-bound
search (``searchsorted(side="left")``), then a clip onto the last alive
lane. This is the portable path's tie rule; the fused weight step
(``ops/resampling_fused.py``) counts ``cdf <= pos`` instead (an upper
bound), as the JAX kernels do, and the two are kept apart.

Positions come from each chain's threefry key (``ops/threefry.py``), so a
chain draws the numbers the JAX function draws for the same key.

Masked lanes: ``num_alive`` (``[C]``) restricts resampling to the first
``num_alive`` lanes of each chain; dead output slots get position 1.0 and
are clipped onto the last alive ancestor.

Metropolis resampling and the particle-sharded pair wait for their ROADMAP
items.
"""

from __future__ import annotations

import torch

from bayesssm_tpu_torch.ops import threefry

__all__ = ["RESAMPLE_METHODS", "resample_indices", "gather_particles"]

RESAMPLE_METHODS = ("stratified", "systematic", "multinomial", "metropolis")


def _validate_weights_eager(weights: torch.Tensor) -> None:
    """The reference's weight checks (non-negative, positive sum)."""
    w = weights.detach().cpu().numpy()
    if (w < 0).any():
        raise ValueError("Weights must be non-negative")
    if not (w.sum(axis=-1) > 0).all():
        raise ValueError("Sum of weights must be greater than 0")


def _positions(keys: torch.Tensor, method: str, n: int,
               num_alive: torch.Tensor) -> torch.Tensor:
    """``[C, n]`` float32 inverse-CDF query positions; ``keys [C, 2]``,
    ``num_alive [C]`` float32."""
    slots = torch.arange(n, dtype=torch.float32, device=keys.device)
    alive = num_alive[:, None]
    if method == "systematic":
        u = threefry.uniform(keys, ())
        pos = (slots + u[:, None]) / alive
    elif method == "stratified":
        pos = (slots + threefry.uniform(keys, (n,))) / alive
    elif method == "multinomial":
        pos = threefry.uniform(keys, (n,))
    else:
        raise ValueError(
            f"unknown resampling method {method!r}; expected one of "
            f"{RESAMPLE_METHODS}"
        )
    return torch.where(slots < alive, pos, 1.0)


def resample_indices(keys, weights: torch.Tensor, method: str = "systematic",
                     num_alive=None, validate: bool = True) -> torch.Tensor:
    """``[C, N]`` int64 ancestor indices in ``[0, num_alive)`` from
    self-normalised ``weights [C, N]`` (zeros on masked lanes).

    ``validate=False`` skips the reference's weight checks, which read the
    weights on the host; the filter engine passes it, as the JAX engine's
    traced call skips them.
    """
    weights = torch.as_tensor(weights)
    if validate:
        _validate_weights_eager(weights)
    c, n = weights.shape
    keys = threefry.as_key_words(keys, weights.device)
    if num_alive is None:
        alive = torch.full((c,), float(n), dtype=weights.dtype,
                           device=weights.device)
    else:
        alive = torch.as_tensor(num_alive, dtype=weights.dtype,
                                device=weights.device).expand(c)
    if method == "metropolis":
        raise NotImplementedError(
            "metropolis resampling is not ported yet (ROADMAP Queue 1, "
            "metropolis resampling)"
        )
    cdf = torch.cumsum(weights, dim=-1)
    pos = _positions(keys, method, n, alive)
    idx = torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=False)
    last_alive = (alive - 1.0).to(torch.int64)[:, None]
    return torch.minimum(idx.clamp_(min=0), last_alive)


def gather_particles(particles: torch.Tensor, idx: torch.Tensor):
    """Gather particle rows by ancestor index: ``particles [C, N]`` or
    ``[C, N, d]``, ``idx [C, N]``."""
    if particles.ndim == idx.ndim:
        return torch.gather(particles, -1, idx)
    return torch.gather(
        particles, -2,
        idx[..., None].expand(*idx.shape, particles.shape[-1]))
