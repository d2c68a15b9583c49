"""Whole-sweep bootstrap filter for the linear-Gaussian SSM.

Port of ``bayesssm_tpu/ops/lgss_sweep_pallas.py`` (``_lgss_op``,
``lgss_bpf_sweep``, ``_lgss_mv_op``, ``lgss_mv_bpf_sweep`` and
``lgss_sweep_pf_impl``). Its log-marginal likelihood has an exact Kalman
value (``utils/kalman.py``), so it anchors the sweep scaffold — plain
version and CUDA kernel alike — to ground truth.

Model: ``x_0 ~ N(0, p0^2)``, ``x_t = a x_{t-1} + sigma_x eps_t``,
``y_t ~ N(c x_t, sigma_y^2)``; the vector form observes
``(y1, y2) = (c1, c2) x_t`` plus independent noise of scales
``(sigma_y1, sigma_y2)``. The callbacks below are the plain-version twins
of ``LgssModel`` and ``LgssMvModel`` in ``csrc/models.cuh``.

Unlike the JAX ``lgss_mv_bpf_sweep``, which rejects SIS while the scalar
sweep takes it, the vector sweep takes SIS too (ROADMAP Queue 3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bayesssm_tpu_torch.ops.sweep_builder import (
    KernelModel,
    build_sweep_op,
    chain_params,
)
from bayesssm_tpu_torch.utils.timing import host_copy, span

__all__ = ["lgss_bpf_sweep", "lgss_mv_bpf_sweep", "lgss_sweep_pf_impl"]

_HALF_LOG_2PI = float(np.float32(0.5 * np.log(2.0 * np.pi)))


@functools.lru_cache(maxsize=None)
def _lgss_op(c_coef: float, p0: float, resample_fn: str,
             always_resample: bool, never_resample: bool):
    c32 = float(np.float32(c_coef))
    p032 = float(np.float32(p0))

    def init(rng, theta):
        return (p032 * rng.normal(),)

    def trans(rng, cols, theta, t):
        a, sx, _ = theta
        return (a * cols[0] + sx * rng.normal(),)

    def lw(cols, theta, y_t):
        _, _, sy = theta
        resid = (y_t - c32 * cols[0]) / sy
        return -0.5 * resid * resid - torch.log(sy) - _HALF_LOG_2PI

    return build_sweep_op(
        1, init, trans, lw, 3, resample_fn=resample_fn,
        always_resample=always_resample, never_resample=never_resample,
        kernel=KernelModel("bssm_sweep_lgss", (c32, p032)),
    )


def lgss_bpf_sweep(
    seed_words,
    y,
    num_particles,
    a,
    sigma_x,
    sigma_y,
    c: float = 1.0,
    p0: float = 1.0,
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
):
    """LGSS bootstrap-filter sweep for ``C`` chains.

    ``seed_words [C, 2]`` (int64 holding uint32 words) fixes both the
    batch size and the device; ``a``, ``sigma_x``, ``sigma_y`` and
    ``num_particles`` are scalars or ``[C]`` tensors. Returns
    ``(loglike [C], state_est [C, T+1])``.
    """
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("lgss_bpf_sweep supports SIS, SISR or SISAR")
    if resample_fn not in ("stratified", "systematic"):
        raise ValueError(
            "lgss_bpf_sweep resamples by inverse-CDF selection over sorted "
            "positions (stratified/systematic)"
        )
    op = _lgss_op(float(c), float(p0), resample_fn,
                  resample_algorithm == "SISR", resample_algorithm == "SIS")
    words = torch.as_tensor(seed_words, dtype=torch.int64)
    return op(words, y, chain_params(words, a, sigma_x, sigma_y),
              num_particles, max_particles=max_particles,
              threshold=threshold)


@functools.lru_cache(maxsize=None)
def _lgss_mv_op(c1: float, c2: float, p0: float, resample_fn: str,
                always_resample: bool, never_resample: bool, obs_gaps):
    c1f, c2f = float(np.float32(c1)), float(np.float32(c2))
    p032 = float(np.float32(p0))

    def init(rng, theta):
        return (p032 * rng.normal(),)

    def trans(rng, cols, theta, t):
        a, sx = theta[0], theta[1]
        return (a * cols[0] + sx * rng.normal(),)

    def lw(cols, theta, y_t):
        sy1, sy2 = theta[2], theta[3]
        y1, y2 = y_t
        r1 = (y1 - c1f * cols[0]) / sy1
        r2 = (y2 - c2f * cols[0]) / sy2
        return (-0.5 * (r1 * r1 + r2 * r2) - torch.log(sy1)
                - torch.log(sy2) - 2.0 * _HALF_LOG_2PI)

    return build_sweep_op(
        1, init, trans, lw, 4, resample_fn=resample_fn,
        always_resample=always_resample, never_resample=never_resample,
        num_obs_cols=2, obs_gaps=obs_gaps,
        kernel=KernelModel("bssm_sweep_lgss_mv", (c1f, c2f, p032)),
    )


def lgss_mv_bpf_sweep(
    seed_words,
    y,
    num_particles,
    a,
    sigma_x,
    sigma_y_vec,
    c_vec=(1.0, 0.5),
    p0: float = 1.0,
    obs_times=None,
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
):
    """Vector-observation LGSS bootstrap-filter sweep (scalar state,
    ``y [T, 2]``) for ``C`` chains. ``obs_times`` (one integer time per
    observation) turns each day's transition into a loop over the days
    since the previous observation. Returns ``(loglike [C],
    state_est [C, T+1])``; the exact value is
    ``utils/kalman.py::kalman_loglik_mv``."""
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("lgss_mv_bpf_sweep supports SIS, SISR or SISAR")
    c1, c2 = (float(v) for v in c_vec)
    sy1, sy2 = sigma_y_vec
    ys = torch.as_tensor(y, dtype=torch.float32)
    obs_gaps = None
    if obs_times is not None:
        from bayesssm_tpu_torch.filters.core import obs_times_to_gaps

        obs_gaps = obs_times_to_gaps(obs_times, ys.shape[0])
    op = _lgss_mv_op(c1, c2, float(p0), resample_fn,
                     resample_algorithm == "SISR",
                     resample_algorithm == "SIS", obs_gaps)
    words = torch.as_tensor(seed_words, dtype=torch.int64)
    return op(words, ys, chain_params(words, a, sigma_x, sy1, sy2),
              num_particles, max_particles=max_particles,
              threshold=threshold)


def lgss_sweep_pf_impl(c: float = 1.0, p0: float = 1.0,
                       interpret: bool = False):
    """PMMH ``pf_impl`` factory for the LGSS whole sweep, with the JAX
    factory's arguments and checks: BPF only, contiguous observation
    times, fresh weights, parameters {a, sigma_x, sigma_y} in any order.
    ``pf(seed_words [C, 2], theta [C, 3], n)`` runs :func:`lgss_bpf_sweep`.
    ``interpret`` is accepted and ignored (the device picks the
    implementation)."""
    del interpret
    expected = ("a", "sigma_x", "sigma_y")

    def factory(y, num_particles, param_names, model_fns, obs_times,
                algorithm, resample_algorithm, resample_fn, carry_weights,
                max_particles=None):
        del model_fns
        if algorithm != "BPF":
            raise ValueError("lgss_sweep_pf_impl supports BPF only")
        if obs_times is not None:
            raise ValueError(
                "lgss_sweep_pf_impl supports contiguous obs_times only"
            )
        if carry_weights:
            raise ValueError(
                "lgss_sweep_pf_impl implements the reference fresh-weight "
                "semantics (carry_weights=False)"
            )
        names = list(param_names)
        if sorted(names) != sorted(expected):
            raise ValueError(
                "lgss_sweep_pf_impl expects parameters "
                "{'a', 'sigma_x', 'sigma_y'}"
            )
        cols = [names.index(q) for q in expected]
        ys = torch.as_tensor(y, dtype=torch.float32)
        on_device = {}

        def pf(seed_words, theta, n=num_particles):
            with span("filter"):
                theta = torch.as_tensor(theta, dtype=torch.float32)
                if theta.device not in on_device:
                    host_copy(ys, theta.device)
                    on_device[theta.device] = ys.to(theta.device)
                a, sx, sy = (theta[:, j] for j in cols)
                return lgss_bpf_sweep(
                    seed_words, on_device[theta.device], n, a, sx, sy, c=c,
                    p0=p0, max_particles=(max_particles
                                          if max_particles is not None
                                          else n),
                    resample_fn=resample_fn,
                    resample_algorithm=resample_algorithm,
                )

        return pf

    return factory
