"""Host milliseconds a filter call takes, from the program's ``filter``
spans (the sweep op's call or the per-day engine's), the median over the
window's unprofiled ``sample_chains`` calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    n, total, _ = ps.spans(call, "filter")
    return total / n * 1e-6 if n else None


def read(t):
    return ps.median_of("sample_chains", _per_call)
