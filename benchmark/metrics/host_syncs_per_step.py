"""Waits of the host on the device per MH step: the program's
``host_sync`` counter over its ``mh_steps`` counter, the median over the
window's unprofiled ``sample_chains`` calls."""

from benchmark.lib import program_spans as ps


def _per_call(call):
    steps = call["counters"].get("mh_steps", 0)
    if not steps:
        return None
    return call["counters"].get("host_sync", 0) / steps


def read(t):
    return ps.median_of("sample_chains", _per_call)
