"""K3, the engine's fused weight step: the least time its work needs.

Bytes: log-weights, ``d`` particle columns, uniform weights read and
thresholds, seed words and counts; particles, weights, ESS and
log-sum-exp written. Instructions: one weight-and-selection stage a live
lane.
"""

from __future__ import annotations

from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import stage_instr


def weight_step(c: int, n: int, d: int, live: float):
    """One weight step over ``c`` chains of ``n`` lanes and ``d`` columns,
    ``live`` of the lanes alive."""
    bytes_moved = 4 * (c * n * (2 + d) + 4 * c) + 4 * (c * n * (1 + d) + 2 * c)
    return bound(bytes_moved, (live, stage_instr(n)))
