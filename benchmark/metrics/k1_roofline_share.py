"""K1's share of its roofline: the least time the profiled sweeps' work
needs (the family's ``roofline/<model>.py``: the sweeps' bytes, the work
the inputs make a filter do, such as the Gillespie events the reference
counted on the checked call's inputs, scaled to the launches) over K1's
device time, %. The launches are the program's counter of the family's
sweep."""

from benchmark.roofline import step

KERNEL = "sweep_kernel"


def read(t):
    w = t.work
    if "model" not in w:
        return None
    fam = step.family(w["model"])
    launches = t.counters.get(fam.SWEEP_COUNTER, 0)
    device_s = t.kernel_s(KERNEL)
    if not launches or device_s <= 0:
        return None
    c = w["chains"]
    one, _ = fam.filter_bound(c, w["lanes"], c * w["particles"], w["days"],
                              w["events_per_filter"] * c)
    return 100.0 * one * launches / device_s
