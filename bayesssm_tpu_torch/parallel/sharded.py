"""Particle-axis sharded filters (port of
``bayesssm_tpu/parallel/sharded.py``).

Chains shard over the ``"chains"`` mesh axis and particles over
``"particles"``: every rank runs the SAME engine as the unsharded path,
``filters/core.py::particle_filter_core``, on its block of chains and its
``N / ps`` lanes of each, with ``particle_axis="particles"``. The engine
then completes its weight reductions over the particle group and
resamples through ``ops/resampling.py::sharded_resample_indices``
(shard-identical positions and one ``all_gather``), so

* the likelihood increment is exactly the unsharded ``max + log(sum
  exp(lw - max)) - log(N)`` (the estimator stays unbiased under sharding);
* every engine feature (observation gaps, masked particle counts, the
  APF's second transition, RMPF moves, ``carry_weights``) holds under
  sharding with no second implementation.

The fused weight step is single-shard and stays off (``use_fused=False``,
as in JAX); the model's own kernels, such as the Gillespie day-step, run
on every rank's lanes.
"""

from __future__ import annotations

import torch

from bayesssm_tpu_torch.filters.core import particle_filter_core
from bayesssm_tpu_torch.ops import threefry

__all__ = ["sharded_particle_filter", "sharded_bootstrap_filter"]


def sharded_particle_filter(
    root_key,
    y,
    num_particles: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    theta: dict,
    num_chains: int,
    mesh,
    algorithm: str = "BPF",
    aux_log_likelihood_fn=None,
    move_fn=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "systematic",
    threshold: float | None = None,
    carry_weights: bool = False,
    *,
    device=None,
):
    """Run a chains- and particles-sharded filter on every rank of
    ``mesh``; returns ``(loglike [num_chains], state_est [num_chains, T,
    d])`` on every rank.

    Args:
      root_key: the ``[2]`` words of one key (``threefry.key(seed)``).
        Chain ``i``'s key is ``fold_in(root_key, i)``, so a chain's
        results do not depend on the rank that runs it.
      theta: dict of ``[num_chains]`` parameter arrays; each rank takes
        its block.
      num_chains / num_particles: GLOBAL counts; each must be divisible by
        its mesh axis.
      algorithm / aux_log_likelihood_fn / move_fn / obs_times /
      resample_* / carry_weights: forwarded to ``particle_filter_core``
        (RMPF always resamples: SISR).
      device: where this rank's tensors live: by default the current CUDA
        device (raises without one); ``"cpu"`` runs on the CPU.

    Returns:
      ``(loglike, state_est)``, gathered over the chains axis; the state
      estimates exclude the t = 0 entry, matching the observation grid.
    """
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("resample_algorithm must be SIS, SISR or SISAR")
    from bayesssm_tpu_torch.ops.resampling import RESAMPLE_METHODS

    if resample_fn not in RESAMPLE_METHODS:
        raise ValueError("unknown resample_fn")

    axes = tuple(mesh.mesh_dim_names)
    cs = mesh.size(axes.index("chains"))
    ps = mesh.size(axes.index("particles"))
    if num_chains % cs or num_particles % ps:
        raise ValueError(
            "num_chains/num_particles must divide the mesh axis sizes"
        )
    from bayesssm_tpu_torch.parallel.collectives import all_gather
    from bayesssm_tpu_torch.parallel.mesh import use_mesh
    from bayesssm_tpu_torch.pmmh.driver import _resolve_device

    dev = _resolve_device(device)
    c_local = num_chains // cs
    lo = mesh.get_local_rank("chains") * c_local
    chain_ids = torch.arange(lo, lo + c_local, device=dev)
    chain_keys = threefry.fold_in(
        threefry.as_key_words(root_key, dev), chain_ids)
    theta_local = {
        k: torch.as_tensor(v, dtype=torch.float32, device=dev)[lo:lo + c_local]
        for k, v in theta.items()
    }
    with use_mesh(mesh):
        res = particle_filter_core(
            chain_keys,
            y,
            num_particles,
            init_fn,
            transition_fn,
            log_likelihood_fn,
            aux_weight_fn=aux_log_likelihood_fn,
            move_fn=move_fn,
            theta=theta_local,
            obs_times=obs_times,
            algorithm=algorithm,
            resample_algorithm=(
                "SISR" if algorithm == "RMPF" else resample_algorithm
            ),
            resample_fn=resample_fn,
            threshold=threshold,
            return_particles=False,
            carry_weights=carry_weights,
            use_fused=False,
            particle_axis="particles",
            particle_axis_size=ps,
        )
        state = res.state_est[:, 1:]            # drop the t = 0 entry
        if state.ndim == 2:
            state = state[..., None]
        return (all_gather(res.loglike, "chains"),
                all_gather(state.contiguous(), "chains"))


def sharded_bootstrap_filter(
    root_key,
    y,
    num_particles: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    theta: dict,
    num_chains: int,
    mesh,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "systematic",
    threshold: float | None = None,
    *,
    device=None,
):
    """Chains- and particles-sharded BPF (see ``sharded_particle_filter``)."""
    return sharded_particle_filter(
        root_key, y, num_particles, init_fn, transition_fn,
        log_likelihood_fn, theta, num_chains, mesh,
        algorithm="BPF", resample_algorithm=resample_algorithm,
        resample_fn=resample_fn, threshold=threshold, device=device,
    )
