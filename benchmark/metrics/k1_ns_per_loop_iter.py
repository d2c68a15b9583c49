"""K1's device nanoseconds a loop iteration: K1's time in the profiled
stretch over the family's K1 launches there times the lanes' own loop
iterations a launch runs (those in which a lane's condition held). The
iterations come from the program's ``sweep.loop_iters`` counter over its
``filter`` spans, the median over the window's unprofiled
``sample_chains`` calls; a program without that counter gives no
number."""

from benchmark.lib import program_spans as ps
from benchmark.roofline import step

KERNEL = "sweep_kernel"


def _loop_iters(call):
    filters = ps.spans(call, "filter")[0]
    iters = call["counters"].get("sweep.loop_iters", 0)
    return iters / filters if filters and iters else None


def read(t):
    w = t.work
    if "model" not in w:
        return None
    launches = t.counters.get(step.family(w["model"]).SWEEP_COUNTER, 0)
    device_s = t.kernel_s(KERNEL)
    per_launch = ps.median_of("sample_chains", _loop_iters)
    if not launches or device_s <= 0 or not per_launch:
        return None
    return device_s * 1e9 / (launches * per_launch)
