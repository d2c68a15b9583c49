"""K4's share of its roofline: the least time the profiled Gillespie days'
work needs (``roofline/k4.py``: the state's bytes and the events the
reference counted a chain-day on the checked call's inputs) over K4's
device time, %."""

from benchmark.roofline import k4

KERNEL = "gillespie_kernel"


def read(t):
    w = t.work
    launches = t.counters.get("bssm_gillespie", 0)
    device_s = t.kernel_s(KERNEL)
    if not launches or device_s <= 0:
        return None
    c = w["chains"]
    one, _ = k4.gillespie_day(c, w["lanes"], w["events_per_day"] * c)
    return 100.0 * one * launches / device_s
