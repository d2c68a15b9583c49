"""K1's device nanoseconds a lane-transition: K1's time in the profiled
stretch over the family's K1 launches there times the lane-transitions
(chains x lanes x the transitions before the weight stages) a launch
covers. The lane-transitions come from the program's
``sweep.lane_transitions`` counter over its ``filter`` spans, the median
over the window's unprofiled ``sample_chains`` calls; a program without
that counter gives no number."""

from benchmark.lib import program_spans as ps
from benchmark.roofline import step

KERNEL = "sweep_kernel"


def _lane_transitions(call):
    filters = ps.spans(call, "filter")[0]
    moves = call["counters"].get("sweep.lane_transitions", 0)
    return moves / filters if filters and moves else None


def read(t):
    w = t.work
    if "model" not in w:
        return None
    launches = t.counters.get(step.family(w["model"]).SWEEP_COUNTER, 0)
    device_s = t.kernel_s(KERNEL)
    per_launch = ps.median_of("sample_chains", _lane_transitions)
    if not launches or device_s <= 0 or not per_launch:
        return None
    return device_s * 1e9 / (launches * per_launch)
