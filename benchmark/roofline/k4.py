"""K4, the engine's Gillespie day: the least time its work needs.

Bytes: the ``[C, N, 2]`` state, seed words and rates read, the state
written. Instructions: the events the inputs fire.
"""

from __future__ import annotations

from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import EVENT_INSTR


def gillespie_day(c: int, n: int, events: float):
    """One day of ``c`` chains of ``n`` lanes that fires ``events``."""
    return bound(4 * (4 * c * n + 4 * c), (events, EVENT_INSTR))
