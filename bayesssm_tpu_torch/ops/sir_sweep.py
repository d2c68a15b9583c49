"""Whole-sweep stochastic-SIR filter (BPF, APF, RMPF) — the port's main path.

Port of ``bayesssm_tpu/ops/sir_sweep_pallas.py``: the SIR callbacks of
``sir_sweep_parts`` (exact Gillespie day, Poisson weight with a
precomputed ``lgamma(y + 1)`` observation column, the same Poisson weight
as the APF lookahead, and the RMPF move on I) on the batched sweep of
``ops/sweep_builder.py``, and the entry points ``sir_filter_sweep`` /
``sir_bpf_sweep``. ``SirModel`` in ``csrc/models.cuh`` is the kernel's
copy of the same callbacks.

The Gillespie day is ``ops/gillespie.py::gillespie_day``, the event loop
the per-day kernel's plain version runs too, here threading the sweep's
own draw counter: each iteration draws ``2 * unroll`` uniform blocks and
applies ``unroll`` events to every lane, and a chain stops when none of
its lanes is active or after ``MAX_EVENTS`` events. A chain's counter,
event count and state move only on the iterations in which that chain
still runs — exactly what one un-batched JAX call (and one kernel block)
does, so every chain's result depends on its own stream alone. The (S, I) packing of the JAX kernel only saved
merge-network work; a gather moves both columns exactly, so it is gone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bayesssm_tpu_torch.ops.gillespie import MAX_EVENTS, gillespie_day
from bayesssm_tpu_torch.ops.sweep_builder import (
    KernelModel,
    build_sweep_op,
    chain_params,
)

__all__ = ["MAX_EVENTS", "sir_sweep_parts", "sir_filter_sweep",
           "sir_bpf_sweep"]

_NEG = -1e30


def sir_sweep_parts(n_total: int, init_infected: int, unroll: int = 8,
                    move_step_max: int = 2):
    """The SIR model as sweep callbacks plus its CUDA functor.

    Returns a dict with ``init_fn``, ``transition_fn``, ``log_weight_fn``,
    ``aux_log_weight_fn`` (the Poisson weight itself), ``move_fn``,
    ``obs_transform`` (appends ``lgamma(y + 1)`` as a second observation
    column), ``num_obs_cols`` and ``kernel`` (the ``KernelModel``).
    """
    inv_nt = float(np.float32(1.0 / float(n_total)))
    nt = float(np.float32(n_total))
    s0 = float(n_total - init_infected)
    i0 = float(init_infected)
    unroll = int(unroll)
    move_step_max = int(move_step_max)

    def init_fn(rng, theta):
        like = theta[0]
        return torch.full_like(like, s0), torch.full_like(like, i0)

    def transition_fn(rng, cols, theta, t):
        s, i = cols
        lam, gam = theta
        s, i, ctr = gillespie_day(rng.keys, rng.counter(), s, i,
                                  lam * inv_nt, gam, 1.0, unroll)
        rng.set_counter(ctr)
        return s, i

    def pois_lw(i, y_v, lgy):
        """Poisson log-pmf in the infectious count, i = 0 exact."""
        safe_i = torch.where(i > 0.0, i, 1.0)
        lw = y_v * torch.log(safe_i) - i - lgy
        return torch.where(
            i > 0.0, lw,
            torch.where(y_v == 0.0, torch.zeros_like(lw),
                        torch.full_like(lw, _NEG)),
        )

    def log_weight_fn(cols, theta, y_t):
        y_v, lgy = y_t
        return pois_lw(cols[1], y_v, lgy)

    def move_fn(rng, cols, theta, y_t):
        """RMPF rejuvenation: ``I' = I + floor(u0 * (2k + 1)) - k``,
        accepted when ``log(u1)`` is below the Poisson likelihood ratio and
        ``I'`` lies in ``[0, n_total - S]``."""
        y_v, lgy = y_t
        s, i = cols
        u = rng.uniforms(2)
        step = torch.floor(u[0] * float(2 * move_step_max + 1)) - float(
            move_step_max)
        i_prop = i + step
        in_support = (i_prop >= 0.0) & (i_prop <= nt - s)
        log_ratio = (pois_lw(torch.clamp_min(i_prop, 0.0), y_v, lgy)
                     - pois_lw(i, y_v, lgy))
        accept = in_support & (torch.log(u[1]) < log_ratio)
        return s, torch.where(accept, i_prop, i)

    def obs_transform(ys):
        ys = torch.as_tensor(ys, dtype=torch.float32).reshape(-1)
        return torch.stack([ys, torch.lgamma(ys + 1.0)], dim=1)

    return dict(
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_weight_fn=log_weight_fn,
        aux_log_weight_fn=log_weight_fn,
        move_fn=move_fn,
        obs_transform=obs_transform,
        num_obs_cols=2,
        kernel=KernelModel("bssm_sweep_sir",
                           (inv_nt, s0, i0, unroll, move_step_max)),
    )


@functools.lru_cache(maxsize=None)
def _sir_op(n_total, init_infected, unroll, method, always_resample,
            never_resample, algorithm="BPF", move_step_max=2, obs_gaps=None):
    parts = sir_sweep_parts(n_total, init_infected, unroll=unroll,
                            move_step_max=move_step_max)
    return build_sweep_op(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        2, aux_log_weight_fn=(parts["aux_log_weight_fn"]
                              if algorithm == "APF" else None),
        move_fn=parts["move_fn"] if algorithm == "RMPF" else None,
        resample_fn=method, always_resample=always_resample,
        never_resample=never_resample, num_obs_cols=2, obs_gaps=obs_gaps,
        kernel=parts["kernel"],
    ), parts["obs_transform"]


def sir_filter_sweep(
    seed_words,
    y,
    num_particles,
    lam,
    gamma,
    n_total,
    init_infected,
    algorithm: str = "BPF",
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
    unroll: int = 8,
    move_step_max: int = 2,
):
    """SIR particle-filter sweep for ``C`` chains: ``algorithm`` "BPF",
    "APF" or "RMPF" (which forces SISR).

    ``seed_words [C, 2]`` fixes the batch and the device; ``lam``,
    ``gamma`` and ``num_particles`` are scalars or ``[C]`` tensors; ``y``
    is the raw ``[T]`` count series. Returns ``(loglike [C],
    state_est [C, T+1, 2])``.
    """
    if algorithm not in ("BPF", "APF", "RMPF"):
        raise ValueError("algorithm must be one of ('BPF', 'APF', 'RMPF')")
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("sir_filter_sweep supports SIS, SISR or SISAR")
    if resample_fn not in ("stratified", "systematic", "multinomial"):
        raise ValueError(f"unknown resample_fn {resample_fn!r}")
    if resample_fn == "multinomial":
        raise ValueError(
            "the whole-sweep selection requires sorted positions "
            "(stratified/systematic); multinomial resampling belongs to the "
            "per-day engine"
        )
    op, obs_transform = _sir_op(
        int(n_total), int(init_infected), int(unroll), resample_fn,
        algorithm == "RMPF" or resample_algorithm == "SISR",
        resample_algorithm == "SIS" and algorithm != "RMPF", algorithm,
        int(move_step_max),
    )
    words = torch.as_tensor(seed_words, dtype=torch.int64)
    y2 = obs_transform(torch.as_tensor(y, dtype=torch.float32,
                                       device=words.device))
    return op(words, y2, chain_params(words, lam, gamma), num_particles, max_particles=max_particles,
              threshold=threshold)


def sir_bpf_sweep(seed_words, y, num_particles, lam, gamma, n_total,
                  init_infected, **kw):
    """Bootstrap-filter specialization of :func:`sir_filter_sweep`."""
    return sir_filter_sweep(seed_words, y, num_particles, lam, gamma,
                            n_total, init_infected, algorithm="BPF", **kw)
