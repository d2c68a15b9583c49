"""K1, the whole-sweep filter kernel: the bytes its work moves.

Bytes: the seed words, observations, theta, counts and thresholds read
once, the log-likelihood and state estimates written once. The
instructions are what the inputs make a filter do, whatever kernel does
it: each model family's ``roofline/<model>.py`` counts them.
"""

from __future__ import annotations


def sweep_bytes(c: int, t: int, d_y: int, p: int, d: int) -> float:
    """Seeds (2), counts and thresholds (2) and theta (``p``) a chain and
    the ``[T, d_y]`` observations read; log-likelihood and ``[T+1, d]``
    estimates written; 4 bytes each."""
    return 4 * ((4 + p) * c + t * d_y) + 4 * (c + c * (t + 1) * d)
