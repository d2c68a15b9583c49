"""Bootstrap particle filter (port of ``bayesssm_tpu/filters/bootstrap.py``).

The weight function is the observation log-likelihood itself; everything
else goes to the shared engine (``filters/core.py``) with
``algorithm="BPF"``. Defaults match the reference: SISAR adaptive
resampling with stratified positions.
"""

from __future__ import annotations

from bayesssm_tpu_torch.filters.core import particle_filter_core

__all__ = ["bootstrap_filter"]


def bootstrap_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
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
    """Run a bootstrap particle filter for each chain of ``key [C, 2]``;
    returns a ``FilterResult`` (the engine's calling convention is in
    ``filters/core.py``)."""
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="BPF",
        resample_algorithm=resample_algorithm,
        resample_fn=resample_fn,
        threshold=threshold,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
        use_fused=use_fused,
    )
