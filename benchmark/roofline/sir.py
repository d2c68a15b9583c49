"""The SIR family's filter work: the least time ``c`` chain-filters need
on their inputs, whichever kernels do them, and the program's counter of
its whole-sweep launches (K1 with the SIR functor)."""

from __future__ import annotations

from benchmark.roofline.k1 import sweep_bytes
from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import EVENT_INSTR, stage_instr

SWEEP_COUNTER = "bssm_sweep_sir"


def filter_bound(c: int, n: int, live: float, t: int, events: float = 0.0):
    """``(seconds, bound_by)`` of ``c`` chain-filters of ``n`` lanes,
    ``live`` alive lanes in all, over ``t`` days: ``events`` Gillespie
    events fired, one weight-and-selection stage a live lane-day."""
    return bound(sweep_bytes(c, t, 2, 2, 2), (events, EVENT_INSTR),
                 (live * t, stage_instr(n)))
