"""The whole MH step: the least time one step's filter work needs on its
inputs, whichever kernels do it (a sweep, or a day loop of per-day
kernels). Each model family states its work in ``roofline/<model>.py``
(``filter_bound`` and ``SWEEP_COUNTER``), found here by the family's
name. The MH arithmetic around the filter is a few operations a chain
and is left out."""

from __future__ import annotations

import importlib


def family(model: str):
    """``roofline/<model>.py``."""
    return importlib.import_module(f"benchmark.roofline.{model}")


def filter_bound(model: str, c: int, n: int, live: float, t: int,
                 events: float = 0.0):
    """``(seconds, bound_by)`` of ``c`` chain-filters of ``n`` lanes,
    ``live`` alive lanes and ``t`` days of the family ``model``."""
    return family(model).filter_bound(c, n, live, t, events)
