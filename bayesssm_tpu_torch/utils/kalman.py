"""Exact Kalman log-likelihoods of the scalar-state linear-Gaussian SSM
(float64, host side), with a scalar or a vector observation: the ground
truth for the LGSS and LGSS-mv sweeps and engine runs.

NumPy copies of ``bayesssm_tpu/utils/kalman.py::kalman_loglik`` and
``kalman_loglik_mv``, so that the port and ``chip_smoke.py`` import nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kalman_loglik", "kalman_loglik_mv"]


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


def kalman_loglik_mv(y, a: float, c_vec, sigma_x: float, sigma_y_vec,
                     m0: float = 0.0, p0: float = 1.0) -> float:
    """Log marginal likelihood of ``x_0 ~ N(m0, p0^2)``,
    ``x_t = a x_{t-1} + N(0, sigma_x^2)``,
    ``y_t = c_vec x_t + N(0, diag(sigma_y_vec^2))`` with ``y`` ``[T, d_y]``
    observed at t = 1..T."""
    y = np.asarray(y, dtype=np.float64)
    if y.ndim != 2:
        raise ValueError("y must be [T, d_y]")
    cv = np.asarray(c_vec, dtype=np.float64).ravel()
    rv = np.asarray(sigma_y_vec, dtype=np.float64).ravel() ** 2
    d = cv.shape[0]
    if y.shape[1] != d or rv.shape[0] != d:
        raise ValueError("c_vec/sigma_y_vec must match y's trailing dim")
    m = float(m0)
    p = float(p0) ** 2
    qx = float(sigma_x) ** 2
    ll = 0.0
    for obs in y:
        m = a * m
        p = a * a * p + qx
        s = np.outer(cv, cv) * p + np.diag(rv)
        resid = obs - cv * m
        _, logdet = np.linalg.slogdet(2.0 * np.pi * s)
        sol = np.linalg.solve(s, resid)
        ll += -0.5 * (logdet + resid @ sol)
        gain = p * (cv @ np.linalg.inv(s))
        m = m + float(gain @ resid)
        p = float((1.0 - gain @ cv) * p)
    return float(ll)
