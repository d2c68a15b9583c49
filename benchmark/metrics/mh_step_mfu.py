"""The whole MH step's share of the card's peak: the least time the
profiled steps' filter work needs on their inputs
(``roofline/step.py``), whichever kernels did it, over the stretch's
wall time, %."""

from benchmark.roofline import step


def read(t):
    w = t.work
    steps = w.get("steps", 0)
    if not steps or t.wall_s <= 0:
        return None
    c = w["chains"]
    one, _ = step.filter_bound(w["model"], c, w["lanes"], c * w["particles"],
                               w["days"], w["events_per_filter"] * c)
    return 100.0 * one * steps / t.wall_s
