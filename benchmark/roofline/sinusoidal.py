"""The README model's filter work: the least time ``c`` chain-filters
need on their inputs, whichever kernels do them, and the program's
counter of its whole-sweep launches (K1c)."""

from __future__ import annotations

from benchmark.roofline.k1 import sweep_bytes
from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import (
    GAUSS_WEIGHT_INSTR,
    NORMAL_INSTR,
    SINF_INSTR,
    instr,
    stage_instr,
)

SWEEP_COUNTER = "bssm_sweep_sinusoidal"


def filter_bound(c: int, n: int, live: float, t: int, events: float = 0.0):
    """An initial normal a live lane, and each day a normal, a sine and
    four float ops, a Gaussian weight and one weight-and-selection stage;
    the model fires no events."""
    del events
    return bound(sweep_bytes(c, t, 1, 3, 1), (live, NORMAL_INSTR),
                 (live * t, instr(NORMAL_INSTR, SINF_INSTR, 4)),
                 (live * t, instr(GAUSS_WEIGHT_INSTR, stage_instr(n))))
