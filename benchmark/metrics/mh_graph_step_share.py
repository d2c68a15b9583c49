"""Share of MH steps run by CUDA-graph replay: the program's
``mh_graph.step`` counter over its ``mh_steps`` counter, in %, the median
over the window's unprofiled ``sample_chains`` calls. A program whose
calls never count an ``mh_graph.*`` counter has no graph replay, and
gives no number."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    steps = call["counters"].get("mh_steps", 0)
    if not steps:
        return None
    return 100.0 * call["counters"].get("mh_graph.step", 0) / steps


def read(t):
    if not any(k.startswith("mh_graph.") for c in ps.calls("sample_chains")
               for k in c["counters"]):
        return None
    return ps.median_of("sample_chains", _per_call)
