"""Exact Kalman log-likelihood of the scalar linear-Gaussian SSM (float64,
host side): the ground truth for the LGSS sweep.

A NumPy copy of ``bayesssm_tpu/utils/kalman.py::kalman_loglik``, so that
the port and ``chip_smoke.py`` import nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kalman_loglik"]


def kalman_loglik(y, a: float, c: float, sigma_x: float, sigma_y: float,
                  m0: float = 0.0, p0: float = 1.0) -> float:
    """Log marginal likelihood of ``x_0 ~ N(m0, p0^2)``,
    ``x_t = a x_{t-1} + N(0, sigma_x^2)``, ``y_t = c x_t + N(0, sigma_y^2)``
    observed at t = 1..T (``p0`` is a standard deviation)."""
    y = np.asarray(y, dtype=np.float64).ravel()
    m = float(m0)
    p = float(p0) ** 2
    qx = float(sigma_x) ** 2
    ry = float(sigma_y) ** 2
    ll = 0.0
    for obs in y:
        m = a * m
        p = a * a * p + qx
        s = c * c * p + ry
        resid = obs - c * m
        ll += -0.5 * (np.log(2.0 * np.pi * s) + resid * resid / s)
        gain = p * c / s
        m = m + gain * resid
        p = (1.0 - gain * c) * p
    return float(ll)
