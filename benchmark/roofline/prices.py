"""Lane instructions of the filters' pieces, counted from the CUDA source
(``ncu`` does not run on the measuring machine, so these are read, not
measured) as ``(all, integer ALU, MUFU or conversion)``. A frozen copy of
the system's smoke-script tables; every price is an assumption.
"""

from __future__ import annotations

import math

# One Gillespie event: two counter draws (14 each), the rates (4), the
# IEEE reciprocal (~6, one MUFU), log1pf (~20, one conversion), and the
# clock, event choice and predicated updates (~14).
EVENT_INSTR = (72, 25, 4)
# A Box-Muller normal (two counter draws, logf ~20, sqrtf ~8, cosf ~25,
# five multiplies and adds); sinf on its fast path; a Gaussian weight
# (subtract, IEEE divide ~8, three multiplies and subtracts, logf ~20).
NORMAL_INSTR = (90, 24, 5)
SINF_INSTR = (25, 4, 0)
GAUSS_WEIGHT_INSTR = (35, 0, 3)
# One op of a functor generated from traced callbacks.
IR_PRICE = {"uniform": (14, 12, 1), "normal": NORMAL_INSTR,
            "exp": (20, 0, 1), "log": (20, 0, 1), "log1p": (20, 0, 1),
            "expm1": (20, 0, 1), "tanh": (20, 0, 1), "sqrt": (8, 0, 1),
            "recip": (8, 0, 1), "sin": SINF_INSTR, "cos": SINF_INSTR,
            "maximum": 3, "minimum": 3, "clamp": 3}


def instr(*parts):
    """Sum of instruction tuples; a plain int counts that many float
    instructions."""
    tuples = [q if isinstance(q, tuple) else (q, 0, 0) for q in parts]
    return tuple(sum(q[j] for q in tuples) for j in range(3))


def stage_instr(n: int):
    """Lane instructions, at least, of one weight-and-selection stage of a
    lane outside the events: log-weight, exp and the normalising divides
    (~50), a position draw (~25), the reductions, the CDF scan and the
    binary search (~20 per halving of ``n`` lanes)."""
    return (100 + 20 * math.log2(n), 0, 6)
