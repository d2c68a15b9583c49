"""The stochastic-volatility family's filter work: the least time ``c``
chain-filters need on their inputs, whichever kernels do them, and the
program's counter of its whole-sweep launches (K1 with the functor
generated from the user's callbacks, priced by ``IR_PRICE``)."""

from __future__ import annotations

from benchmark.roofline.k1 import sweep_bytes
from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import IR_PRICE, instr, stage_instr

SWEEP_COUNTER = "bssm_sweep_generated"


def filter_bound(c: int, n: int, live: float, t: int, events: float = 0.0):
    """An initial normal a live lane, and each live lane-day a normal and
    three float ops (the transition), the Gaussian log-weight (one
    ``exp`` and five float ops) and one weight-and-selection stage; the
    model fires no events."""
    del events
    return bound(sweep_bytes(c, t, 1, 3, 1), (live, IR_PRICE["normal"]),
                 (live * t, instr(IR_PRICE["normal"], 3, IR_PRICE["exp"], 5,
                                  stage_instr(n))))
