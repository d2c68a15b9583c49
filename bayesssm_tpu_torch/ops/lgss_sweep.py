"""Whole-sweep bootstrap filter for the linear-Gaussian SSM.

Port of ``bayesssm_tpu/ops/lgss_sweep_pallas.py`` (``_lgss_op`` and
``lgss_bpf_sweep``). Its log-marginal likelihood has an exact Kalman
value (``utils/kalman.py``), so it anchors the sweep scaffold — plain
version and CUDA kernel alike — to ground truth.

Model: ``x_0 ~ N(0, p0^2)``, ``x_t = a x_{t-1} + sigma_x eps_t``,
``y_t ~ N(c x_t, sigma_y^2)``. The callbacks below are the plain-version
twins of ``LgssModel`` in ``csrc/models.cuh``.
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

__all__ = ["lgss_bpf_sweep"]

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
    return op(words, y, chain_params(words, a, sigma_x, sigma_y), num_particles, max_particles=max_particles,
              threshold=threshold)
