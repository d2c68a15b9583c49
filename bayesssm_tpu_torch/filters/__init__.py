"""The generic particle-filter engine and the bootstrap filter."""

from bayesssm_tpu_torch.filters.bootstrap import bootstrap_filter
from bayesssm_tpu_torch.filters.core import (
    FilterConfig,
    FilterResult,
    particle_filter_core,
)

__all__ = ["particle_filter_core", "FilterConfig", "FilterResult",
           "bootstrap_filter"]
