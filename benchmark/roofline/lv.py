"""The Lotka-Volterra CLE family's filter work: the least time ``c``
chain-filters need on their inputs, whichever kernels do them, and the
program's counter of its whole-sweep launches (K1 with the functor
generated from the user's callbacks, priced by ``IR_PRICE``).

A filter of ``t`` observations makes ``obs_every`` Euler-Maruyama steps
before each of its ``t`` weight stages; ``obs_every`` is read from the
configuration's file, so the bound follows the schedule. The op counts
below are those of the functor the tracer emits from
``programs/lv.py``'s callbacks (``ops/sweep_codegen.py``'s IR): ``float``
counts the adds, subtracts, multiplies and negations, one instruction
each; an IEEE division is priced as a reciprocal and a multiply.
"""

from __future__ import annotations

import json
import pathlib

from benchmark.roofline.k1 import sweep_bytes
from benchmark.roofline.peaks import bound
from benchmark.roofline.prices import IR_PRICE, instr, stage_instr

SWEEP_COUNTER = "bssm_sweep_generated"
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "lv_cle_smfsb.json"

# Ops of each traced callback.
INIT_OPS = {"normal": 2, "clamp": 2, "float": 4}
TRANSITION_OPS = {"normal": 2, "sqrt": 2, "div": 1, "clamp": 4, "float": 23}
LOG_WEIGHT_OPS = {"float": 9}


def price(ops: dict):
    """Lane instructions of a callback's ops."""
    prices = dict(IR_PRICE, float=1, div=instr(IR_PRICE["recip"], 1))
    return instr(*(prices[op] for op, k in ops.items() for _ in range(k)))


def obs_every() -> int:
    """Euler steps between observations, from the configuration."""
    return int(json.loads(CONFIG.read_text())["obs_every"])


def work(live: float, t: int, n: int, steps: int | None = None):
    """``(count, instructions)`` of the init, the transitions and the
    weight stages of ``live`` alive lanes over ``t`` observations with
    ``steps`` Euler steps before each (the configuration's by default)."""
    steps = obs_every() if steps is None else int(steps)
    return {"init": (live, price(INIT_OPS)),
            "transition": (live * t * steps, price(TRANSITION_OPS)),
            "stage": (live * t, instr(price(LOG_WEIGHT_OPS),
                                      stage_instr(n)))}


def filter_bound(c: int, n: int, live: float, t: int, events: float = 0.0):
    """Two normals a live lane to start; each live lane-transition two
    normals, two square roots, a guarded division and 27 float ops and
    clamps; each live lane-day the two-column Gaussian log-weight and one
    weight-and-selection stage. The model fires no events."""
    del events
    return bound(sweep_bytes(c, t, 2, 3, 2), *work(live, t, n).values())
