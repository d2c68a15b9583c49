"""Inverse-CDF selection, the contract of ``bayesssm_tpu/ops/merge_select.py``.

For each output slot k the selection returns ``v[m_k]`` with
``m_k = #{j : cdf_ext_j <= pos_k}``. The JAX package computes it with a
bitonic lane-roll merge network (``merge_select_cols`` after
``resolve_carries``) because Mosaic has no gather; both only copy values,
so a search and a gather give the same bits. The CUDA sweep kernel does
the same with a binary search per thread (``csrc/select.cuh``); the fused
weight step and the standalone entry ``bssm_select`` run it one warp a row
(``csrc/warp_reduce.cuh::search_slots``), with ``searchsorted``'s
comparison, so a NaN entry or position selects as here.

``cdf_ext`` is non-decreasing and pinned to a sentinel above every
position from the last alive lane on, so ``m_k <= N - 1`` on the sweep's
path; for other inputs ``m_k`` is clamped to ``N - 1`` here and in the
kernel alike.
"""

from __future__ import annotations

import torch

from bayesssm_tpu_torch.ops import _build

__all__ = ["select_index", "select_cols", "select_cols_reference"]


def select_index(cdf_ext: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``m_k`` as an int64 ``[R, N]`` tensor (``searchsorted`` upper
    bound, clamped to the last lane)."""
    m = torch.searchsorted(cdf_ext.contiguous(), pos.contiguous(),
                           right=True)
    return m.clamp_(max=cdf_ext.shape[-1] - 1)


def select_cols_reference(cdf_ext, pos, cols):
    """Plain PyTorch selection: one gather per column of ``cols``."""
    m = select_index(cdf_ext, pos)
    return tuple(torch.gather(c, -1, m) for c in cols)


def select_cols(cdf_ext: torch.Tensor, pos: torch.Tensor, cols):
    """Selected ``[R, N]`` columns ``cols[j][m_k]`` (module docstring).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``bssm_select`` (one warp a row, ``csrc/resample.cu``).
    """
    cols = tuple(cols)
    if cdf_ext.device.type == "cpu":
        return select_cols_reference(cdf_ext, pos, cols)
    return _build.launch_select(cdf_ext, pos, cols)
