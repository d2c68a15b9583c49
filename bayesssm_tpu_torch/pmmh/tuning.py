"""Pilot-run tuning for PMMH (port of ``bayesssm_tpu/pmmh/tuning.py``).

* :func:`run_pilot_chain` — a non-adaptive random-walk Metropolis pilot
  chain of length ``pilot_m`` with per-parameter proposal SDs; a proposal
  outside the prior support is drawn again, at most
  ``MAX_PROPOSAL_TRIES`` times (Q7). Posterior mean and covariance are
  taken on the UNTRANSFORMED second half of the chain (Q6).
* :func:`pilot_run` — ``pilot_reps`` filter evaluations at the pilot
  posterior mean; ``target_n = clamp(ceil(pilot_n * var), 50, 1000)``
  (Q10).

The JAX functions are single-chain and the JAX driver ``vmap``s them;
here every function takes a leading chain axis: keys are ``[C, 2]`` key
words (``ops/threefry.py``), theta is ``[C, P]``. A chain's results depend
only on its own key, and they follow the JAX key schedule draw for draw:
``split(key)`` for the first evaluation, ``split(key, 4)`` per pilot step,
the propose loop's own ``split``s, and ``split(key, pilot_reps)`` for
:func:`pilot_run`. Each filter is called with the words of its key.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bayesssm_tpu_torch.filters.core import particle_filter_core
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.pmmh.priors import sum_log_priors
from bayesssm_tpu_torch.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    transform_params,
)
from bayesssm_tpu_torch.utils.timing import (
    host_copy,
    host_sync,
    span,
    spanned,
)

__all__ = ["TuneControl", "default_tune_control", "run_pilot_chain",
           "pilot_run", "_make_pf_loglike"]

_RESAMPLE_ALGOS = ("SISAR", "SISR", "SIS")
_RESAMPLE_FNS = ("stratified", "systematic", "multinomial")

# Cap on the reference's unbounded re-propose-until-valid loop (Q7).
MAX_PROPOSAL_TRIES = 100

TARGET_N_MIN = 50
TARGET_N_MAX = 1000

# Particle lanes one pilot_run filter call takes (rows x lanes): at the
# pilot's 128 lanes, 131,072 rows per call.
PILOT_LANES_PER_CALL = 1 << 24


@dataclasses.dataclass(frozen=True)
class TuneControl:
    """Validated pilot tuning configuration. ``pilot_target_var`` and
    ``pilot_burn_in`` are kept for parity with the reference's
    configuration and are never read by the tuning (Q10; the pilot chain
    always discards its first half)."""

    pilot_proposal_sd: float = 0.5
    pilot_n: int = 100
    pilot_m: int = 2000
    pilot_target_var: float = 1.0
    pilot_burn_in: int = 500
    pilot_reps: int = 100
    pilot_resample_algorithm: str = "SISAR"
    pilot_resample_fn: str = "stratified"


def default_tune_control(
    pilot_proposal_sd: float = 0.5,
    pilot_n: int = 100,
    pilot_m: int = 2000,
    pilot_target_var: float = 1.0,
    pilot_burn_in: int = 500,
    pilot_reps: int = 100,
    pilot_resample_algorithm: str = "SISAR",
    pilot_resample_fn: str = "stratified",
) -> TuneControl:
    """Create validated tuning controls (the JAX function's checks and
    messages)."""
    if not (pilot_proposal_sd >= 0 and np.isfinite(pilot_proposal_sd)):
        raise ValueError("pilot_proposal_sd must be a finite non-negative number")
    for name, val in [
        ("pilot_n", pilot_n),
        ("pilot_m", pilot_m),
        ("pilot_burn_in", pilot_burn_in),
        ("pilot_reps", pilot_reps),
    ]:
        if not isinstance(val, int) or val < 1:
            raise ValueError(f"{name} must be a positive integer")
    if not (pilot_target_var >= 0):
        raise ValueError("pilot_target_var must be non-negative")
    if pilot_resample_algorithm not in _RESAMPLE_ALGOS:
        raise ValueError(f"pilot_resample_algorithm must be one of {_RESAMPLE_ALGOS}")
    if pilot_resample_fn not in _RESAMPLE_FNS:
        raise ValueError(f"pilot_resample_fn must be one of {_RESAMPLE_FNS}")
    return TuneControl(
        pilot_proposal_sd=float(pilot_proposal_sd),
        pilot_n=int(pilot_n),
        pilot_m=int(pilot_m),
        pilot_target_var=float(pilot_target_var),
        pilot_burn_in=int(pilot_burn_in),
        pilot_reps=int(pilot_reps),
        pilot_resample_algorithm=pilot_resample_algorithm,
        pilot_resample_fn=pilot_resample_fn,
    )


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
    the fused weight-step kernel. With ``particle_axis`` each call runs
    the particle-sharded engine on this rank's ``max_particles /
    particle_axis_size`` lanes, inside ``parallel.mesh.use_mesh`` (the
    fused step is then off, as in JAX).
    """
    init_fn, transition_fn, log_likelihood_fn, aux_fn, move_fn = model_fns
    names = list(param_names)
    on_device = {}

    def pf(seed_words, theta_vec, n=num_particles):
        theta_vec = torch.as_tensor(theta_vec, dtype=torch.float32)
        dev = theta_vec.device
        if dev not in on_device:
            host_copy(y, dev)
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
            particle_axis=particle_axis,
            particle_axis_size=particle_axis_size,
        )
        return res.loglike, res.state_est

    return pf


def _propose_until_valid(key, z, proposal_sd, transforms, prior_fns,
                         theta_curr):
    """Bounded re-propose loop (Q7) for every chain of ``key [C, 2]``.

    Try ``i`` draws ``z' = z + sd * eps`` from the second key of the
    ``i``-th ``split``; a chain keeps its first proposal with a finite
    prior, and falls back to its current (always valid) theta when none of
    ``MAX_PROPOSAL_TRIES`` is. The host asks once per try whether any
    chain is still without one.
    """
    p = z.shape[-1]
    theta = theta_curr
    pending = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for _ in range(MAX_PROPOSAL_TRIES):
        key, k = threefry.split(key).unbind(1)
        zp = z + proposal_sd * threefry.normal(k, (p,))
        thp = back_transform_params(zp, transforms)
        valid = torch.isfinite(sum_log_priors(thp, prior_fns))
        theta = torch.where((pending & valid)[:, None], thp, theta)
        pending = pending & ~valid
        host_sync(pending)
        if not bool(pending.any()):
            break
    return theta


@spanned("pilot")
def run_pilot_chain(
    key,
    y,
    param_names,
    model_fns,
    prior_fns,
    init_theta,
    transforms,
    control: TuneControl,
    obs_times=None,
    algorithm: str = "BPF",
    jacobian_convention: str = "consistent",
    carry_weights: bool = False,
    pf_impl=None,
):
    """Run the pilot RWM chain and the pilot variance run of every chain
    of ``key [C, 2]`` (tensor key words; the chains run on its device)
    from ``init_theta [C, P]``; returns a dict of tensors with a leading
    chain axis: pilot_theta_mean [C, P], pilot_theta_cov [C, P, P]
    (untransformed scale, Q6), target_n [C], variance_estimate [C],
    pilot_theta_chain [C, pilot_m, P], pilot_loglike_chain [C, pilot_m]
    and pilot_accept_rate [C].

    ``pf_impl`` optionally replaces ``_make_pf_loglike`` (same signature),
    e.g. ``sir_sweep_pf_impl(...)`` for the whole-sweep kernel.
    """
    key = threefry.as_key_words(key)
    dev = key.device
    host_copy(init_theta, dev)
    init_theta = torch.as_tensor(init_theta, dtype=torch.float32, device=dev)
    proposal_sd = float(np.float32(control.pilot_proposal_sd))
    # The pilot filter's lanes are padded to a multiple of 128; masked
    # lanes keep the effective particle count at exactly pilot_n.
    lanes = ((control.pilot_n + 127) // 128) * 128
    pf = (pf_impl or _make_pf_loglike)(
        y,
        control.pilot_n,
        param_names,
        model_fns,
        obs_times,
        algorithm,
        control.pilot_resample_algorithm,
        control.pilot_resample_fn,
        carry_weights,
        max_particles=lanes,
    )

    key, k0 = threefry.split(key).unbind(1)
    ll0, _ = pf(k0, init_theta)

    theta, ll = init_theta, ll0
    thetas, lls = [theta], [ll]
    accepted = torch.zeros(key.shape[0], dtype=torch.float32, device=dev)
    for _ in range(control.pilot_m - 1):
        with span("step"):
            key, k_prop, k_pf, k_acc = threefry.split(key, 4).unbind(1)
            z = transform_params(theta, transforms)
            theta_prop = _propose_until_valid(k_prop, z, proposal_sd,
                                              transforms, prior_fns, theta)
            ll_prop, _ = pf(k_pf, theta_prop)
            log_ratio = (
                sum_log_priors(theta_prop, prior_fns)
                + ll_prop
                + log_jacobian(theta_prop, transforms, jacobian_convention)
            ) - (
                sum_log_priors(theta, prior_fns)
                + ll
                + log_jacobian(theta, transforms, jacobian_convention)
            )
            log_ratio = torch.where(torch.isnan(log_ratio), -math.inf,
                                    log_ratio)
            accept = torch.log(threefry.uniform(k_acc)) < log_ratio
            theta = torch.where(accept[:, None], theta_prop, theta)
            ll = torch.where(accept, ll_prop, ll)
            thetas.append(theta)
            lls.append(ll)
            accepted = accepted + accept.to(torch.float32)
    theta_chain = torch.stack(thetas, dim=1)
    loglike_chain = torch.stack(lls, dim=1)

    # Posterior summaries on the untransformed second half (Q6).
    post = theta_chain[:, control.pilot_m // 2:]
    theta_mean = post.mean(dim=1)
    centered = post - theta_mean[:, None]
    theta_cov = torch.einsum("cmp,cmq->cpq", centered, centered) / (
        post.shape[1] - 1)

    with span("variance_run"):
        target_n, var_est = pilot_run(
            key, theta_mean, pf, control,
            max_rows=max(1, PILOT_LANES_PER_CALL // lanes))

    return {
        "pilot_theta_mean": theta_mean,
        "pilot_theta_cov": theta_cov,
        "target_n": target_n,
        "variance_estimate": var_est,
        "pilot_theta_chain": theta_chain,
        "pilot_loglike_chain": loglike_chain,
        "pilot_accept_rate": accepted / max(control.pilot_m - 1, 1),
    }


def pilot_run(key, theta_mean, pf, control: TuneControl, max_rows=None):
    """``Var(loglike)`` at ``theta_mean [C, P]`` over ``pilot_reps`` filter
    runs per chain, and the particle count it asks for: ``(target_n [C],
    variance [C])``.

    The ``C x pilot_reps`` runs are rows of one batched filter call, or of
    several calls of at most ``max_rows`` rows; row ``(c, r)`` always
    takes key ``r`` of ``split(key[c], pilot_reps)``. The variance is
    float32 with ddof = 1, mean first and then the sum of squares, as
    ``jnp.var`` takes it.
    """
    c, p = theta_mean.shape
    reps = control.pilot_reps
    keys = threefry.split(key, reps).reshape(c * reps, 2)
    thetas = theta_mean[:, None, :].expand(c, reps, p).reshape(c * reps, p)
    step = c * reps if max_rows is None else int(max_rows)
    lls = torch.cat([
        pf(keys[i:i + step], thetas[i:i + step])[0]
        for i in range(0, c * reps, step)
    ]).reshape(c, reps)
    mean = lls.sum(dim=1, keepdim=True) / reps
    centered = lls - mean
    var_est = (centered * centered).sum(dim=1) / (reps - 1)
    # -inf loglikes give an inf/NaN variance -> the maximum particle count.
    var_safe = torch.where(torch.isnan(var_est), math.inf, var_est)
    target = torch.ceil(control.pilot_n * var_safe)
    return torch.clamp(target, TARGET_N_MIN, TARGET_N_MAX), var_est
