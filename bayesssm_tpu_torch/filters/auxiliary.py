"""Auxiliary particle filter (port of ``bayesssm_tpu/filters/auxiliary.py``).

A lookahead ``aux_log_likelihood_fn`` steers an extra resample before a
second transition; the day's weights subtract the chosen ancestors' aux
log-weights. Everything goes to the shared engine (``filters/core.py``)
with ``algorithm="APF"``, which reproduces the reference's double
transition (quirk Q2).
"""

from __future__ import annotations

from bayesssm_tpu_torch.filters.core import particle_filter_core

__all__ = ["auxiliary_filter"]


def auxiliary_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    aux_log_likelihood_fn,
    theta=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    threshold=None,
    return_particles: bool = True,
    max_particles=None,
    carry_weights: bool = False,
    use_fused: str | bool = "auto",
):
    """Run an auxiliary particle filter for each chain of ``key [C, 2]``;
    returns a ``FilterResult`` (the engine's calling convention is in
    ``filters/core.py``)."""
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        aux_weight_fn=aux_log_likelihood_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="APF",
        resample_algorithm=resample_algorithm,
        resample_fn=resample_fn,
        threshold=threshold,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
        use_fused=use_fused,
    )
