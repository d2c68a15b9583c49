"""Share of the engine's filter days whose weight step (mask, degenerate
check, log-likelihood, ESS record and, but in RMPF, state estimate) ran
inside K3's one launch: the program's ``engine.k3_days`` counter over its
``engine.days``, in %, the median over the window's unprofiled
``sample_chains`` calls. A program that never counts ``engine.days`` gives
no number."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    days = call["counters"].get("engine.days", 0)
    if not days:
        return None
    return 100.0 * call["counters"].get("engine.k3_days", 0) / days


def read(t):
    if not any("engine.days" in c["counters"]
               for c in ps.calls("sample_chains")):
        return None
    return ps.median_of("sample_chains", _per_call)
