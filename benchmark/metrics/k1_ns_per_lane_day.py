"""K1's device nanoseconds a lane-day: K1's time in the profiled stretch
over the family's K1 launches there times the lane-days (chains x lanes x
days) a launch covers. The lane-days come from the program's
``sweep.lane_days`` counter over its ``filter`` spans, the median over
the window's unprofiled ``sample_chains`` calls."""

from benchmark.lib import program_spans as ps
from benchmark.roofline import step

KERNEL = "sweep_kernel"


def _lane_days(call):
    filters = ps.spans(call, "filter")[0]
    days = call["counters"].get("sweep.lane_days", 0)
    return days / filters if filters and days else None


def read(t):
    w = t.work
    if "model" not in w:
        return None
    launches = t.counters.get(step.family(w["model"]).SWEEP_COUNTER, 0)
    device_s = t.kernel_s(KERNEL)
    per_launch = ps.median_of("sample_chains", _lane_days)
    if not launches or device_s <= 0 or not per_launch:
        return None
    return device_s * 1e9 / (launches * per_launch)
