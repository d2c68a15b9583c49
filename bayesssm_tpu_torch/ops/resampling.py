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

``"metropolis"`` is Murray's sort-free resampler
(:func:`metropolis_resample_indices`).

Particle-sharded resampling (:func:`sharded_resample_indices`,
:func:`sharded_gather`) runs on each shard's ``[C, N / ps]`` block of a
particle axis sharded over a mesh axis (``parallel/collectives.py``).
"""

from __future__ import annotations

import warnings

import torch

from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.utils.timing import host_sync

__all__ = ["RESAMPLE_METHODS", "resample_indices",
           "metropolis_resample_indices", "gather_particles",
           "sharded_resample_indices", "sharded_gather"]

RESAMPLE_METHODS = ("stratified", "systematic", "multinomial", "metropolis")

# Output slots times steps whose draws one block of Metropolis steps holds,
# by device type: on a card 2**24 (at 4096 chains x 128 slots, 32 steps,
# each draw 64 MiB of int32 words); on the CPU 2**18, whose words stay in
# cache (3x faster than 2**24 at 64 x 512).
METROPOLIS_BLOCK_SLOTS = {"cuda": 1 << 24, "cpu": 1 << 18}


def _validate_weights_eager(weights: torch.Tensor) -> None:
    """The reference's weight checks (non-negative, positive sum)."""
    host_sync(weights)
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
        return metropolis_resample_indices(keys, weights, num_alive=alive)
    cdf = torch.cumsum(weights, dim=-1)
    pos = _positions(keys, method, n, alive)
    idx = torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=False)
    last_alive = (alive - 1.0).to(torch.int64)[:, None]
    return torch.minimum(idx.clamp_(min=0), last_alive)


def metropolis_resample_indices(keys, weights: torch.Tensor,
                                num_steps: int | None = None,
                                num_alive=None,
                                num_out: int | None = None) -> torch.Tensor:
    """Metropolis resampling (Murray 2012, arXiv:1202.6163): ``[C, n_out]``
    int64 ancestor indices from weights ``[C, N]`` (unnormalised is fine)
    and one key ``[C, 2]`` a chain.

    Each output slot runs ``num_steps`` Metropolis steps over ancestor
    indices with acceptance ratio ``w_proposal / w_current``; no cumulative
    sum and no search. A finite chain leaves a bias that decays as about
    35 / ``num_steps`` nats of log-likelihood, so the default is
    ``max(256, N // 8)`` and fewer steps warn. ``num_alive`` (``[C]`` or a
    number) clamps the chain starts and the proposals onto the first
    ``num_alive`` lanes; ``num_out`` sets the number of output slots (one a
    lane by default).

    A chain's indices equal the JAX function's for its key, bit for bit:
    ``split(key, num_steps)``, then ``k_u, k_p = split(k)`` a step, the
    proposal ``min(floor(uniform(k_p) * num_alive), num_alive - 1)`` and the
    test ``uniform(k_u) * w_cur < w_prop``. The draws do not depend on the
    chain's state, so they are made ahead, for blocks of steps at once
    (``METROPOLIS_BLOCK_SLOTS``), with the proposals' weights; the step
    loop carries ``w_cur`` beside the index (always ``weights[idx]``) and
    is four elementwise operations a step.
    """
    weights = torch.as_tensor(weights)
    c, n = weights.shape
    calibrated = max(256, n // 8)
    if num_steps is None:
        num_steps = calibrated
    elif num_steps < 1:
        raise ValueError(
            f"num_steps must be >= 1 (got {num_steps}); a zero-length "
            "Metropolis chain would return the identity resample"
        )
    elif num_steps < calibrated:
        warnings.warn(
            f"metropolis resampling with num_steps={num_steps} below "
            f"the calibrated default {calibrated}: expect a "
            f"log-likelihood bias of roughly 35/num_steps = "
            f"{35.0 / num_steps:.2f} nats (worse for concentrated "
            "weights)",
            stacklevel=2,
        )
    n_out = n if num_out is None else int(num_out)
    dev = weights.device
    keys = threefry.as_key_words(keys, dev)
    if num_alive is None:
        alive = torch.full((c, 1, 1), float(n), dtype=weights.dtype,
                           device=dev)
    else:
        alive = torch.as_tensor(num_alive, dtype=weights.dtype,
                                device=dev).expand(c).reshape(c, 1, 1)
    last_alive = (alive - 1.0).to(torch.int64)
    idx = torch.minimum(torch.arange(n_out, device=dev),
                        last_alive[:, 0])
    w_cur = torch.gather(weights, 1, idx)
    step_keys = threefry.split(keys, num_steps)             # [C, S, 2]
    budget = METROPOLIS_BLOCK_SLOTS.get(dev.type,
                                        METROPOLIS_BLOCK_SLOTS["cpu"])
    block = max(1, min(num_steps, budget // (c * n_out)))
    for lo in range(0, num_steps, block):
        k_u, k_p = threefry.split(step_keys[:, lo:lo + block]).unbind(-2)
        proposal = torch.minimum(
            torch.floor(threefry.uniform(k_p, (n_out,)) * alive).to(
                torch.int64),
            last_alive)                                     # [C, b, n_out]
        u = threefry.uniform(k_u, (n_out,))
        w_prop = torch.gather(weights, 1, proposal.reshape(c, -1)).reshape(
            proposal.shape)
        for s in range(proposal.shape[1]):
            accept = u[:, s] * w_cur < w_prop[:, s]
            idx = torch.where(accept, proposal[:, s], idx)
            w_cur = torch.where(accept, w_prop[:, s], w_cur)
    return idx


def gather_particles(particles: torch.Tensor, idx: torch.Tensor):
    """Gather particle rows by ancestor index: ``particles [C, N]`` or
    ``[C, N, d]``, ``idx [C, N]``."""
    if particles.ndim == idx.ndim:
        return torch.gather(particles, -1, idx)
    return torch.gather(
        particles, -2,
        idx[..., None].expand(*idx.shape, particles.shape[-1]))


def sharded_resample_indices(keys, weights_local: torch.Tensor, method: str,
                             axis_name: str, num_alive) -> torch.Tensor:
    """Inverse-CDF resampling over a particle axis sharded on
    ``axis_name``: this shard's ``[C, n_local]`` GLOBAL ancestor indices.

    ``weights_local [C, n_local]`` is this shard's slice of globally
    normalised weights (``normalize_log_weights(axis_name=...)``) and
    ``keys [C, 2]`` must be the same on every shard. Every shard draws the
    positions of ALL global slots from ``keys``, keeps its own slots,
    searches them in the gathered global CDF (one ``all_gather``) and
    clips onto the last alive lane, so the ancestors are those of the
    unsharded ``resample_indices``. ``"metropolis"`` runs the chains of
    this shard's own output slots over the gathered weights, from
    ``fold_in(keys, shard)``.
    """
    from bayesssm_tpu_torch.parallel.collectives import (
        all_gather,
        axis_index,
    )

    c, n_local = weights_local.shape
    dev = weights_local.device
    keys = threefry.as_key_words(keys, dev)
    w_all = all_gather(weights_local, axis_name, dim=1)
    n_global = w_all.shape[1]
    alive = torch.as_tensor(num_alive, dtype=w_all.dtype,
                            device=dev).expand(c).contiguous()
    shard = axis_index(axis_name)
    if method == "metropolis":
        return metropolis_resample_indices(
            threefry.fold_in(keys, shard), w_all, num_alive=alive,
            num_out=n_local)
    lo = shard * n_local
    pos = _positions(keys, method, n_global, alive)[:, lo:lo + n_local]
    cdf = torch.cumsum(w_all, dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=False)
    last_alive = (alive - 1.0).to(torch.int64)[:, None]
    return torch.minimum(idx.clamp_(min=0), last_alive)


def sharded_gather(x_local: torch.Tensor, idx_global: torch.Tensor,
                   axis_name: str) -> torch.Tensor:
    """Rows of a particle-sharded ``x_local [C, n_local(, d)]`` by GLOBAL
    ancestor index ``idx_global [C, n_local]`` (from
    ``sharded_resample_indices``): one ``all_gather`` of the global array,
    then a gather."""
    from bayesssm_tpu_torch.parallel.collectives import all_gather

    return gather_particles(all_gather(x_local, axis_name, dim=1),
                            idx_global)
