"""What the program's own spans and counters recorded, for the per-layer
metrics that read them.

``bayesssm_tpu_torch.utils.timing.recent_calls()`` keeps, for each of the
program's last root calls (``pmmh``, or ``sample_chains`` called
directly), the host-clock totals of the spans inside it by path and the
change of each counter over it. A reader keeps the roots of one kind that
ran with no profiler recording, so that its number is free of the
profiler's cost, and takes the median over them of a per-call value: the
median keeps out the set-up call, which loads the kernels inside its
first filter, and a checked call. A program without these records gives
no calls, and the reader no number.
"""

from __future__ import annotations

import statistics


def calls(root: str) -> list:
    """The recorded unprofiled calls whose root span is ``root``."""
    try:
        from bayesssm_tpu_torch.utils.timing import recent_calls
    except ImportError:
        return []
    return [c for c in recent_calls()
            if c.get("root") == root and not c.get("profiled")]


def spans(call: dict, leaf: str) -> tuple:
    """``(count, total ns, self ns)`` summed over the call's span paths
    that end in ``leaf`` (one name, or names joined by ``/``)."""
    n = total = own = 0
    for path, a in call["spans"].items():
        if path == leaf or path.endswith("/" + leaf):
            n += a["count"]
            total += a["total_ns"]
            own += a["self_ns"]
    return n, total, own


def median_of(root: str, per_call):
    """The median over ``root``'s calls of ``per_call(call)``, leaving out
    the calls it gives None for; None without any."""
    values = [v for v in map(per_call, calls(root)) if v is not None]
    return statistics.median(values) if values else None


def engine_stage_ms(stage: str):
    """Host ms a filter call spends in the engine's ``stage`` spans, the
    median over the unprofiled ``sample_chains`` calls."""
    def per_call(call):
        filters = spans(call, "filter")[0]
        n, total, _ = spans(call, stage)
        return total / filters * 1e-6 if filters and n else None

    return median_of("sample_chains", per_call)
