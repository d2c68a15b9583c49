"""Host milliseconds a filter call of the whole sweep spends issuing its
work: the program's ``prepare`` and ``launch`` spans (``ops/
sweep_builder.py::SweepOp``), over the call's ``filter`` spans, the
median over the window's unprofiled ``sample_chains`` calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    filters = ps.spans(call, "filter")[0]
    n_prep, prep, _ = ps.spans(call, "prepare")
    n_launch, launch, _ = ps.spans(call, "launch")
    if not filters or not n_prep or not n_launch:
        return None
    return (prep + launch) / filters * 1e-6


def read(t):
    return ps.median_of("sample_chains", _per_call)
