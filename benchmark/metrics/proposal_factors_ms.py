"""Host milliseconds a ``pmmh()`` call spends turning the pilot's
covariances into proposal factors (the program's ``proposal_factors``
span around ``chain_state_from_pilot``), the median over the window's
unprofiled ``pmmh()`` calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    n, total, _ = ps.spans(call, "proposal_factors")
    return total * 1e-6 if n else None


def read(t):
    return ps.median_of("pmmh", _per_call)
