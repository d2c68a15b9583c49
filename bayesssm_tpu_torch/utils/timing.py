"""Per-phase wall-clock timing (port of ``bayesssm_tpu/utils/timing.py``).

PyTorch returns before the card has finished the work it was given, so on
a CUDA device a phase ends with ``torch.cuda.synchronize()`` before the
clock is read: otherwise a phase would time only the host's issuing of
work.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["PhaseTimer"]


class PhaseTimer:
    """Collects wall-clock seconds per named phase; ``device`` is the
    device whose queued work a phase waits for before it stops the
    clock."""

    def __init__(self, verbose: bool = False, device=None):
        self.timings: dict[str, float] = {}
        self.verbose = verbose
        self.device = torch.device(device) if device is not None else None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"[timing] {name}: {elapsed:.2f}s")
