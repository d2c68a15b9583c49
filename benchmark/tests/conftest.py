"""CPU tests of the benchmark: small shapes, the program's plain versions.

The per-day engine's weight step runs on the card as its fused kernel
with in-kernel positions; on the CPU the program's engine would take its
portable path instead, so the fixture ``card_paths`` routes it through
the fused step's plain version, as the card routes it through the kernel.
"""

from __future__ import annotations

import functools
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("sir.sweep", "sir.engine", "sinusoidal.engine")
PMMH_CELLS = ("sir.pmmh",)
# Small shapes of each cell: chains, alive lanes, lane bound.
TINY = {"sir.sweep": (8, 128, 128), "sir.engine": (8, 100, 128),
        "sinusoidal.engine": (8, 100, 128)}
# Small ``pmmh()`` calls: chains, samples, burn-in and a short pilot.
TINY_PMMH = dict(chains=8, m=8, burn_in=3,
                 tune=dict(pilot_m=8, pilot_burn_in=4, pilot_reps=4))


def tiny_cell(name: str, root=None):
    from benchmark.lib.spec import load_cell

    cell = load_cell(name, root)
    if name in PMMH_CELLS:
        cell.workload.update(TINY_PMMH, trace_calls=1)
        return cell
    chains, particles, lanes = TINY[name]
    cell.workload.update(chains=chains, particles=particles, lanes=lanes,
                         steps_per_call=2, trace_calls=1)
    return cell


@pytest.fixture
def card_paths(monkeypatch):
    from bayesssm_tpu_torch.pmmh import tuning

    monkeypatch.setattr(tuning, "particle_filter_core", functools.partial(
        tuning.particle_filter_core, use_fused="interpret-inkernel"))
