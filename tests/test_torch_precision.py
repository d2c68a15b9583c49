"""Numerical precision of the port's engine, the mirror of
``tests/test_precision.py``.

* float32 against float64: the reference is double-precision R and the
  engine runs float32 with max-shifted log-weights. A model whose
  ``init_fn`` returns float64 particles runs the engine in float64 (its
  observations, log-weights, normalisation, CDF and likelihood); the
  float32 estimate must agree with it within Monte-Carlo error. The port's
  threefry draws float32 normals only (``jax.random.normal`` under x64
  draws float64 ones), so the float64 run's particles move by float32
  normals; its arithmetic is float64 throughout.
* No NaN anywhere: the counterpart of ``jax_debug_nans`` is a
  ``TorchFunctionMode`` that raises on a NaN in the output of any torch
  operation while one LGSS filter runs, so the branchless ``-inf``
  handling must not make a NaN on the normal path.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from bayesssm_tpu_torch.filters import bootstrap_filter
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops import threefry

torch.set_num_threads(1)

(INIT_FN, TRANSITION_FN, LOGLIK_FN), _, _ = lgss_model()
THETA = {"a": 0.9, "sigma_x": 0.6, "sigma_y": 0.4}


def init64(key, num_particles):
    return threefry.normal(key, (num_particles,)).double()


def test_f32_matches_f64_crosscheck():
    _, y = simulate_lgss(1405, t_val=20)
    keys64 = torch.stack([threefry.key(k) for k in range(16)])
    f64 = bootstrap_filter(keys64, y, 2048, init64, TRANSITION_FN,
                           LOGLIK_FN, theta=THETA, resample_algorithm="SISR",
                           return_particles=False).loglike
    assert f64.dtype == torch.float64
    f32 = bootstrap_filter(threefry.split(threefry.key(100), 16), y, 2048,
                           INIT_FN, TRANSITION_FN, LOGLIK_FN, theta=THETA,
                           resample_algorithm="SISR",
                           return_particles=False).loglike
    assert f32.dtype == torch.float32
    # The same estimator at two precisions: the means agree within their
    # combined Monte-Carlo error (std / sqrt(16) each, ~0.03 here).
    assert abs(f32.double().mean().item() - f64.mean().item()) < 0.1


class RaiseOnNan(TorchFunctionMode):
    """Raise as soon as any torch operation returns a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and torch.isnan(t).any()):
                raise FloatingPointError(f"NaN from {func}")
        return out


def test_nan_mode_catches_a_nan():
    with pytest.raises(FloatingPointError):
        with RaiseOnNan():
            torch.log(torch.tensor([-1.0]))


def test_engine_clean_under_nan_checks():
    _, y = simulate_lgss(3, t_val=10)
    with RaiseOnNan():
        res = bootstrap_filter(threefry.key(0)[None], y, 256, INIT_FN,
                               TRANSITION_FN, LOGLIK_FN, theta=THETA,
                               return_particles=False)
    assert np.isfinite(res.loglike.numpy()).all()
