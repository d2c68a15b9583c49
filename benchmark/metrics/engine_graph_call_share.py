"""Share of the engine's filter calls run by CUDA-graph replay: the
program's ``engine_graph.replay`` counter over its ``filter`` spans, in %,
the median over the window's unprofiled ``sample_chains`` calls. A program
whose calls never count an ``engine_graph.*`` counter has no filter graph,
and gives no number."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    filters = ps.spans(call, "filter")[0]
    if not filters:
        return None
    return 100.0 * call["counters"].get("engine_graph.replay", 0) / filters


def read(t):
    if not any(k.startswith("engine_graph.") for c in ps.calls("sample_chains")
               for k in c["counters"]):
        return None
    return ps.median_of("sample_chains", _per_call)
