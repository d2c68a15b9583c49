"""PMMH: priors, transforms, pilot tuning and the two-phase driver.

The subpackage's name is the name of the public ``pmmh()`` entry point.
Importing any submodule (``bayesssm_tpu_torch.pmmh.driver``) binds this
module as the ``pmmh`` attribute of the top-level package, over the lazy
function export, so the module itself is callable and forwards to
``driver.pmmh``: ``bayesssm_tpu_torch.pmmh(...)`` works whatever was
imported first, as in the JAX package. Exports load lazily: importing the
subpackage loads no submodule.
"""

import sys as _sys
import types as _types

_EXPORTS = {
    "pmmh": "bayesssm_tpu_torch.pmmh.driver",
    "default_tune_control": "bayesssm_tpu_torch.pmmh.tuning",
    "TuneControl": "bayesssm_tpu_torch.pmmh.tuning",
    "ess": "bayesssm_tpu_torch.diagnostics.ess",
    "rhat": "bayesssm_tpu_torch.diagnostics.rhat",
    "PMMHOutput": "bayesssm_tpu_torch.output",
    "SSM": "bayesssm_tpu_torch.ssm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _CallableModule(_types.ModuleType):
    """A module that forwards calls to ``driver.pmmh``."""

    def __call__(self, *args, **kwargs):
        from bayesssm_tpu_torch.pmmh.driver import pmmh

        return pmmh(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
