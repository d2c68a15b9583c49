"""The Lotka-Volterra family under exact Gillespie simulation: the least
time ``c`` chain-filters need on their inputs, whichever kernels do them,
and the program's counter of its whole-sweep launches (K1 with the
functor generated from the user's callbacks, priced by ``IR_PRICE``).

The work is the loop iterations the inputs make every lane run, the
``events`` the reference counted on the checked call's inputs, and a
weight stage a live lane-day. Those iterations are of two loops, priced
apart. The start's Poisson arrivals run while an arrival falls below the
species' mean, so a lane runs ``mean + 1`` of them a species in
expectation, for every one of the ``n`` lanes of a chain: that many are
priced as arrivals (the realized count differs by about 1e-4 of itself
at the cell's size) and the rest of ``events`` as the transition's
events. The op counts below are those of one iteration of each loop of
the functor the tracer emits from ``programs/lvssa.py``'s callbacks
(``ops/sweep_codegen.py``'s IR, the condition and the body): ``float``
counts the adds, subtracts, multiplies and negations, ``compare``,
``logical`` and ``where`` one instruction each, and the division by the
hazard is priced as a reciprocal and a multiply. The means are read from
the configuration file.
"""

from __future__ import annotations

import json
import pathlib

from benchmark.roofline.k1 import sweep_bytes
from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import IR_PRICE, instr, stage_instr

SWEEP_COUNTER = "bssm_sweep_generated"
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "lv_ssa_smfsb.json"

# Ops of one iteration (condition and body) of the transition's event
# loop, of the start's arrival loop, and of the log-weight.
EVENT_OPS = {"uniform": 2, "log1p": 1, "div": 1, "float": 19, "compare": 7,
             "logical": 5, "where": 4}
ARRIVAL_OPS = {"uniform": 1, "log1p": 1, "float": 3, "compare": 2,
               "where": 1}
LOG_WEIGHT_OPS = {"float": 9}


def arrivals_per_lane() -> float:
    """The start's expected arrival iterations a lane: ``mean + 1`` a
    species."""
    return sum(float(m) + 1.0
               for m in json.loads(CONFIG.read_text())["x0_mean"])


def price(ops: dict):
    """Lane instructions of a callback's ops."""
    prices = dict(IR_PRICE, float=1, compare=1, logical=1, where=1,
                  div=instr(IR_PRICE["recip"], 1))
    return instr(*(prices[op] for op, k in ops.items() for _ in range(k)))


def work(live: float, t: int, n: int, events: float, lanes: float):
    """``(count, instructions)`` of the start's arrivals on ``lanes``
    lanes, the rest of the ``events`` loop iterations, and the weight
    stages of ``live`` alive lanes over ``t`` observations."""
    arrivals = min(lanes * arrivals_per_lane(), events)
    return {"arrivals": (arrivals, price(ARRIVAL_OPS)),
            "events": (events - arrivals, price(EVENT_OPS)),
            "stage": (live * t, instr(price(LOG_WEIGHT_OPS),
                                      stage_instr(n)))}


def filter_bound(c: int, n: int, live: float, t: int, events: float = 0.0):
    """``events`` loop iterations of ``c`` chains of ``n`` lanes: the
    start's arrivals, each a counter uniform, a ``log1pf`` and a compare
    and select, and the transition's events, each two counter uniforms, a
    ``log1pf``, a division, the hazards and the reaction's compares and
    selects; each live lane-day the two-column Gaussian log-weight and one
    weight-and-selection stage."""
    return bound(sweep_bytes(c, t, 2, 3, 2),
                 *work(live, t, n, events, c * n).values())
