"""Fused per-day weight step (K3): the plain PyTorch version and its CUDA
kernel.

Port of ``bayesssm_tpu/ops/resampling_pallas.py``. For each chain of a
``[C, N]`` batch, one call fuses the filter engine's weight step:

    max shift -> exp -> sum -> normalise -> ESS -> log-sum-exp ->
    running-max CDF -> positions -> selection -> adaptive choice

* :func:`fused_weight_resample` takes the inverse-CDF positions as an
  input (drawn by ``ops/resampling.py::_positions`` from the chain's key:
  the same stream as the portable path);
* :func:`fused_weight_resample_seeded` draws them itself from each chain's
  two key words with the JAX kernel's software stream
  (``ops/rng.py::position_uniforms``): stratified ``(j + U_j) / alive``,
  systematic with lane 0's draw for every slot, multinomial iid; dead
  slots get position 1.0.

Selection follows the JAX kernel, not the portable path: slot ``k`` takes
the ancestor ``m_k = #{j : cdf_ext_j <= pos_k}`` (an upper bound, as
``merge_select`` counts it), where ``cdf_ext`` is the running-max CDF
pinned to 1.5 from the last alive lane on (the highest lane with a
positive ``uniform_w``). Output slots past the alive count take the last
alive ancestor's values, as in the JAX kernel; the engine never reads
them. With ``always_resample`` every chain resamples; otherwise a chain
resamples when its ``ess < threshold``, and returns its particles and
weights unchanged when not.

Sums over lanes follow the kernel's halving tree (``tree_sum``) and the
CDF its doubling scan (``running_cdf``), and the search is
``searchsorted``'s, so the CUDA kernel (``csrc/resample.cu``: one warp a
chain, its lanes in registers) and :func:`fused_weight_resample_reference`
agree bit for bit on the card. The public functions route by device: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.

**The engine's day.** Given the running ``loglike [C]``, ``dead [C]``
(bool) and ``log_n [C]`` with ``num_alive``, one call is the filter
engine's whole weight step on the day's raw log-weights: lanes at or above
a chain's count masked to ``-inf`` and clamped at ``-1e30``, ``dead``
updated in place (``max < DEGENERATE_LOG_WEIGHT``), the log-likelihood
``where(dead, -inf, loglike + (lse - log_n))``, the ESS record (the count
after a resample, else the ESS; 0 once dead), a dead chain's weights
zeroed and, with ``estimate``, the state estimate ``sum_n w[n] x[n, :]`` of
the output weights and particles in the halving tree. The call then
returns ``(particles, weights, ess, logsumexp, loglike, ess_record,
estimate)`` (``estimate`` None without it); without ``loglike`` it is the
step above, unchanged.
"""

from __future__ import annotations

import math

import torch

from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.merge_select import select_index
from bayesssm_tpu_torch.ops.rng import position_uniforms
from bayesssm_tpu_torch.ops.sweep_builder import running_cdf, tree_sum
from bayesssm_tpu_torch.ops.weights import DEGENERATE_LOG_WEIGHT

__all__ = [
    "FUSED_FLOOR",
    "MAX_FUSED_LANES",
    "POSITION_METHODS",
    "fused_weight_resample",
    "fused_weight_resample_seeded",
    "fused_weight_resample_reference",
    "inkernel_positions",
]

# One chain's lanes share one warp, at most 32 lanes a thread.
MAX_FUSED_LANES = 1024
POSITION_METHODS = ("stratified", "systematic", "multinomial")
_SENTINEL = 1.5
# Clamp of -inf log-weights entering the fused weight step (the engine's
# day clamps its masked log-weights in the kernel).
FUSED_FLOOR = -1e30


def _as(x, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).expand(shape).contiguous()


def _prepare(lw, particles, uniform_w, threshold):
    lw = torch.as_tensor(lw, dtype=torch.float32).contiguous()
    if lw.ndim != 2:
        raise ValueError(f"log_weights must be [C, N] (got {tuple(lw.shape)})")
    c, n = lw.shape
    if n > MAX_FUSED_LANES:
        raise ValueError(
            f"the fused weight step takes at most {MAX_FUSED_LANES} lanes "
            f"(got {n})")
    parts = torch.as_tensor(particles, dtype=torch.float32,
                            device=lw.device).contiguous()
    if parts.ndim != 3 or parts.shape[:2] != (c, n):
        raise ValueError(
            f"particles must be [C, N, d] = [{c}, {n}, d] (got "
            f"{tuple(parts.shape)})")
    return lw, parts, _as(uniform_w, lw, (c, n)), _as(threshold, lw, (c,))


def inkernel_positions(key_words: torch.Tensor, method: str, n: int,
                       num_alive: torch.Tensor) -> torch.Tensor:
    """``[C, n]`` positions the kernel draws from ``key_words [C, 2]``
    (``resampling_pallas.py:156-184``); ``num_alive [C]``."""
    u = position_uniforms(key_words, n)
    lane_f = torch.arange(n, dtype=torch.float32, device=u.device)
    alive = num_alive[:, None]
    if method == "stratified":
        pos = (lane_f + u) / alive
    elif method == "systematic":
        pos = (lane_f + u[:, :1]) / alive
    else:
        pos = u
    return torch.where(lane_f < alive, pos, 1.0)


def _day_log_weights(lw, num_alive):
    """The day's raw log-weights masked at each chain's count and clamped,
    as the kernel loads them."""
    lane_f = torch.arange(lw.shape[1], dtype=torch.float32, device=lw.device)
    masked = torch.where(lane_f < num_alive[:, None], lw, -math.inf)
    return torch.clamp_min(masked, FUSED_FLOOR)


def _estimate(weights, parts):
    """``sum_n w[c, n] * p[c, n, j]`` in the kernel's halving tree over
    its ``max(32, 2^k)`` lanes (the padding adds zeros): ``[C, D]``."""
    prod = (weights[..., None] * parts).transpose(1, 2)
    n = prod.shape[-1]
    if n < 32:
        prod = torch.cat([prod, prod.new_zeros(prod.shape[:-1] + (32 - n,))],
                         dim=-1)
    return tree_sum(prod)[..., 0]


def fused_weight_resample_reference(lw, particles, uniform_w, threshold, *,
                                    positions=None, key_words=None,
                                    num_alive=None, method=None,
                                    always_resample=False, loglike=None,
                                    dead=None, log_n=None, estimate=False):
    """The plain PyTorch weight step on any device (the kernel's twin).

    Give ``positions [C, N]``, or ``key_words [C, 2]``, ``num_alive [C]``
    and a position ``method``. Returns ``(particles_out [C, N, d],
    weights_out [C, N], ess [C], logsumexp [C])``; with ``loglike``,
    ``dead``, ``log_n`` and ``num_alive``, the engine's day (module
    docstring) and its three outputs more.
    """
    lw, parts, uni, thr = _prepare(lw, particles, uniform_w, threshold)
    c, n = lw.shape
    day = loglike is not None
    if day and num_alive is None:
        raise ValueError("the engine day needs num_alive [C]")
    if num_alive is not None:
        num_alive = _as(num_alive, lw, (c,))
    if day:
        lw = _day_log_weights(lw, num_alive)
    mx = torch.amax(lw, dim=1, keepdim=True)
    shifted = torch.exp(lw - mx)
    s = tree_sum(shifted)
    w = shifted / s
    ess = (1.0 / tree_sum(w * w))[:, 0]
    lse = (mx + torch.log(s))[:, 0]
    lane = torch.arange(n, device=lw.device)
    last_alive = torch.amax(torch.where(uni > 0.0, lane, 0), dim=1,
                            keepdim=True)
    cdf = torch.where(lane >= last_alive, _SENTINEL, running_cdf(w))
    if method is None:
        pos = _as(positions, lw, lw.shape)
    else:
        pos = inkernel_positions(
            torch.as_tensor(key_words, dtype=torch.int64, device=lw.device),
            method, n, num_alive)
    m = select_index(cdf, pos)
    res = torch.gather(parts, 1, m[..., None].expand_as(parts))
    if always_resample:
        do = torch.ones((c, 1), dtype=torch.bool, device=lw.device)
        p_out, w_out = res, uni
    else:
        do = (ess < thr)[:, None]
        p_out = torch.where(do[..., None], res, parts)
        w_out = torch.where(do, uni, w)
    if not day:
        return p_out, w_out, ess, lse
    dead |= mx[:, 0] < DEGENERATE_LOG_WEIGHT
    ll = torch.where(dead, -math.inf, loglike + (lse - log_n))
    ess_rec = torch.where(dead, 0.0, torch.where(do[:, 0], num_alive, ess))
    w_out = torch.where(dead[:, None], 0.0, w_out)
    est = _estimate(w_out, p_out) if estimate else None
    return p_out, w_out, ess, lse, ll, ess_rec, est


def _day(loglike, dead, log_n, estimate):
    """The day's arguments of the launcher (none outside a day)."""
    if loglike is None:
        return {}
    return dict(loglike=loglike, dead=dead, log_n=log_n, estimate=estimate)


def fused_weight_resample(lw, particles, positions, uniform_w, threshold,
                          always_resample: bool = False, *, num_alive=None,
                          loglike=None, dead=None, log_n=None,
                          estimate=False):
    """Fused weight step with given positions ``[C, N]`` (module
    docstring). ``lw``/``uniform_w`` ``[C, N]``, ``particles [C, N, d]``,
    ``threshold`` scalar or ``[C]``; the engine's day with ``loglike``,
    ``dead``, ``log_n`` and ``num_alive``."""
    if torch.as_tensor(lw).device.type == "cpu":
        return fused_weight_resample_reference(
            lw, particles, uniform_w, threshold, positions=positions,
            num_alive=num_alive, always_resample=always_resample,
            loglike=loglike, dead=dead, log_n=log_n, estimate=estimate)
    lw, parts, uni, thr = _prepare(lw, particles, uniform_w, threshold)
    return _build.launch_fused_resample(
        lw, parts, uni, thr, always=always_resample,
        pos=_as(positions, lw, lw.shape),
        alive=(None if loglike is None or num_alive is None
               else _as(num_alive, lw, (lw.shape[0],))),
        **_day(loglike, dead, log_n, estimate))


def fused_weight_resample_seeded(lw, particles, key_words, num_alive,
                                 uniform_w, threshold,
                                 method: str = "stratified",
                                 always_resample: bool = False, *,
                                 loglike=None, dead=None, log_n=None,
                                 estimate=False):
    """Fused weight step that draws its positions from each chain's key
    words ``[C, 2]`` (module docstring); ``num_alive`` scalar or ``[C]``;
    the engine's day with ``loglike``, ``dead`` and ``log_n``."""
    if method not in POSITION_METHODS:
        raise ValueError(f"unknown resampling method {method!r}")
    if torch.as_tensor(lw).device.type == "cpu":
        return fused_weight_resample_reference(
            lw, particles, uniform_w, threshold, key_words=key_words,
            num_alive=num_alive, method=method,
            always_resample=always_resample, loglike=loglike, dead=dead,
            log_n=log_n, estimate=estimate)
    lw, parts, uni, thr = _prepare(lw, particles, uniform_w, threshold)
    words = torch.as_tensor(key_words, dtype=torch.int64, device=lw.device)
    return _build.launch_fused_resample(
        lw, parts, uni, thr, always=always_resample, words=words,
        alive=_as(num_alive, lw, (lw.shape[0],)),
        method=POSITION_METHODS.index(method),
        **_day(loglike, dead, log_n, estimate))
