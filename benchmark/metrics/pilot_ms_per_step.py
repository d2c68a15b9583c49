"""Host milliseconds a pilot step takes in ``pmmh()``'s tuning, from the
program's ``pilot/step`` spans (``pmmh/tuning.py run_pilot_chain``), the
median over the window's unprofiled ``pmmh()`` calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    n, total, _ = ps.spans(call, "pilot/step")
    return total / n * 1e-6 if n else None


def read(t):
    return ps.median_of("pmmh", _per_call)
