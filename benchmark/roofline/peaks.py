"""Peaks of one NVIDIA H100 SXM at its 700 W limit, and the bound.

The data sheet's HBM bandwidth, 3.35 TB/s, and 67 TFLOP/s in float32
outside the tensor cores, which counts a fused multiply-add as two: 128
lanes x 2 x 132 SMs x 1.98 GHz, so ``SM_CLOCKS_S`` is 132 x 1.98e9 SM
clocks a second. Lane instructions per SM and clock on compute capability
9.0 (the CUDA C++ Programming Guide's throughput table): four schedulers
issue 32 lanes each, 64 integer adds, logic ops, shifts and compares, 16
MUFU operations (reciprocal, exp2, log2) or conversions. The kernels are
built with ``--fmad=false``, so a float32 add or multiply is one
instruction. A frozen copy of the prices the system's smoke script used.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
SM_CLOCKS_S = 67e12 / (2 * 128)
ISSUE_PER_SM, ALU_PER_SM, XU_PER_SM = 128, 64, 16


def bound(bytes_moved: float, *work):
    """``(seconds, "bytes" | "operations")``: the larger of the bytes over
    the memory rate and the lane instructions over the rate of their pipe.
    Each ``work`` item is ``(count, (all, alu, xu))``: ``count`` times that
    many lane instructions of each kind."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    issue, alu, xu = (sum(k * w[j] for k, w in work) for j in range(3))
    t_ops = max(issue / ISSUE_PER_SM, alu / ALU_PER_SM,
                xu / XU_PER_SM) / SM_CLOCKS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
