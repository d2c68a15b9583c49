"""Host milliseconds a filter call of the per-day engine spends in its
``keys`` spans (``filters/core.py``), the median over the window's
unprofiled ``sample_chains`` calls."""

from benchmark.lib import program_spans as ps


def read(t):
    return ps.engine_stage_ms("keys")
