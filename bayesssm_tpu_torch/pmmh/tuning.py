"""PMMH filter evaluation through the generic engine (port of
``_make_pf_loglike`` from ``bayesssm_tpu/pmmh/tuning.py``).

Pilot tuning itself (``default_tune_control``, ``run_pilot_chain``,
``pilot_run``) is not ported yet (ROADMAP Queue 1, ``pmmh()`` with tuning,
output and diagnostics).
"""

from __future__ import annotations

import torch

from bayesssm_tpu_torch.filters.core import particle_filter_core

__all__ = ["_make_pf_loglike"]


def _make_pf_loglike(
    y,
    num_particles,
    param_names,
    model_fns,
    obs_times,
    algorithm,
    resample_algorithm,
    resample_fn,
    carry_weights,
    max_particles=None,
    particle_axis=None,
    particle_axis_size=1,
):
    """Build the batched ``pf(seed_words [C, 2], theta [C, P],
    n=num_particles) -> (loglike [C], state_est)`` that ``sample_chains``
    takes, for a fixed filter configuration.

    ``model_fns`` is ``(init_fn, transition_fn, log_likelihood_fn,
    aux_fn, move_fn)``; ``theta`` columns follow ``param_names``. The
    filter runs with ``use_fused="auto"``, the engine's default, as the
    JAX function's does: on CUDA tensors every SISR/SISAR day goes through
    the fused weight-step kernel. ``particle_axis`` sharding is not ported
    yet (ROADMAP Queue 1, multi-GPU).
    """
    if particle_axis is not None:
        raise NotImplementedError(
            "particle_axis sharding is not ported yet (ROADMAP Queue 1, "
            "multi-GPU)")
    del particle_axis_size
    init_fn, transition_fn, log_likelihood_fn, aux_fn, move_fn = model_fns
    names = list(param_names)
    on_device = {}

    def pf(seed_words, theta_vec, n=num_particles):
        theta_vec = torch.as_tensor(theta_vec, dtype=torch.float32)
        dev = theta_vec.device
        if dev not in on_device:
            on_device[dev] = torch.as_tensor(y, dtype=torch.float32,
                                             device=dev)
        theta = {name: theta_vec[:, j] for j, name in enumerate(names)}
        res = particle_filter_core(
            key=torch.as_tensor(seed_words, device=dev),
            y=on_device[dev],
            num_particles=n,
            init_fn=init_fn,
            transition_fn=transition_fn,
            weight_fn=log_likelihood_fn,
            aux_weight_fn=aux_fn,
            move_fn=move_fn,
            theta=theta,
            obs_times=obs_times,
            algorithm=algorithm,
            resample_algorithm=resample_algorithm,
            resample_fn=resample_fn,
            return_particles=False,
            max_particles=max_particles,
            carry_weights=carry_weights,
        )
        return res.loglike, res.state_est

    return pf
