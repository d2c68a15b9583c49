"""Host milliseconds an MH step spends outside its filter, from the
program's ``mh_step`` spans (self time: the step less its ``filter``
span), the median over the window's unprofiled ``sample_chains``
calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    n, _, own = ps.spans(call, "mh_step")
    return own / n * 1e-6 if n else None


def read(t):
    return ps.median_of("sample_chains", _per_call)
