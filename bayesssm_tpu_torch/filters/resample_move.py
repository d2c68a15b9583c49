"""Resample-move particle filter (port of
``bayesssm_tpu/filters/resample_move.py``).

Every day resamples (SISR), then an MCMC rejuvenation ``move_fn`` runs on
the resampled particles: batched over ``[C, N(, d)]``, or written for one
particle (``utils/signatures.py::adapt_move_fn``). Everything goes to the
shared engine (``filters/core.py``) with ``algorithm="RMPF"``.
"""

from __future__ import annotations

from bayesssm_tpu_torch.filters.core import particle_filter_core

__all__ = ["resample_move_filter"]


def resample_move_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    move_fn,
    theta=None,
    obs_times=None,
    resample_fn: str = "stratified",
    return_particles: bool = True,
    max_particles=None,
    carry_weights: bool = False,
    use_fused: str | bool = "auto",
):
    """Run a resample-move particle filter for each chain of ``key [C,
    2]``; returns a ``FilterResult``. There is no ``resample_algorithm``
    argument: RMPF always resamples, as the reference does."""
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        move_fn=move_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="RMPF",
        resample_algorithm="SISR",
        resample_fn=resample_fn,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
        use_fused=use_fused,
    )
