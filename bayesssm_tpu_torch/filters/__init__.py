"""The generic particle-filter engine and the three filters."""

from bayesssm_tpu_torch.filters.auxiliary import auxiliary_filter
from bayesssm_tpu_torch.filters.bootstrap import bootstrap_filter
from bayesssm_tpu_torch.filters.core import (
    FilterConfig,
    FilterResult,
    particle_filter_core,
)
from bayesssm_tpu_torch.filters.resample_move import resample_move_filter

__all__ = ["particle_filter_core", "FilterConfig", "FilterResult",
           "bootstrap_filter", "auxiliary_filter", "resample_move_filter"]
