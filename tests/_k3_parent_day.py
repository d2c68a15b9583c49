"""The engine's bootstrap filter with its weight step as it ran before K3
took the whole day: the alive mask, the degenerate check and the -1e30
clamp as PyTorch ops before K3 (called without the day's arguments), the
log-likelihood, ESS record and zeroed weights as ops after it, and the
state estimate by PyTorch's sum. The draws are the engine's
(``filters/core.py``), so the filter on the same key words is the engine's
chain for chain; and the inputs of one day (:func:`day_case`). Imports only
torch, numpy and the port: the card's tests use it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesssm_tpu_torch.filters.core import (
    _observations,
    _per_chain,
    _weighted_sum,
)
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.resampling_fused import (
    fused_weight_resample_seeded,
)
from bayesssm_tpu_torch.ops.weights import DEGENERATE_LOG_WEIGHT
from bayesssm_tpu_torch.utils.signatures import adapt_fn


def old_weight_step(lw, particles, k_res, loglike, dead, n_f, log_n,
                    uniform_w, thr, always):
    """One day's weight step of the former engine on raw log-weights
    ``lw [C, N]``: ``(particles, weights, ess_rec, loglike, dead)``."""
    n = lw.shape[1]
    lane = torch.arange(n, dtype=lw.dtype, device=lw.device)
    lw = torch.where(lane < n_f[:, None], lw, -math.inf)
    dead = dead | (torch.amax(lw, dim=1) < DEGENERATE_LOG_WEIGHT)
    p3 = particles if particles.ndim == 3 else particles[..., None]
    p3, weights, ess, lse = fused_weight_resample_seeded(
        torch.clamp_min(lw, -1e30), p3, k_res, n_f, uniform_w, thr,
        "stratified", always)
    particles = p3 if particles.ndim == 3 else p3[..., 0]
    loglike = torch.where(dead, -math.inf, loglike + (lse - log_n))
    ess_rec = n_f if always else torch.where(ess < thr, n_f, ess)
    weights = torch.where(dead[:, None], 0.0, weights)
    ess_rec = torch.where(dead, 0.0, ess_rec)
    return particles, weights, ess_rec, loglike, dead


def old_bootstrap_filter(words, y, n, init_fn, transition_fn, weight_fn,
                         theta, always=False):
    """The former engine's BPF (stratified, SISAR at n / 2 or, with
    ``always``, SISR) at ``n`` lanes, every lane alive: ``(loglike [C],
    loglike_history [C, T], ess [C, T+1], particles_history, weights_history,
    state_est)`` as ``FilterResult`` holds them."""
    init = adapt_fn(init_fn, "init_fn", required=("num_particles",))
    trans = adapt_fn(transition_fn, "transition_fn", required=("particles",))
    weight = adapt_fn(weight_fn, "weight_fn", required=("particles", "y"))
    c, dev = words.shape[0], words.device
    ys = _observations(y, dev)
    theta = {k: _per_chain(v, c, torch.float32, dev)
             for k, v in theta.items()}
    key_run, k_init = threefry.split(words).unbind(1)
    step_keys = threefry.split(key_run, (ys.shape[0], 5))
    particles = init(key=k_init, num_particles=n, **theta)
    n_f = torch.full((c,), float(n), device=dev)
    log_n = torch.log(n_f)
    thr = torch.zeros_like(n_f) if always else n_f / 2.0
    uniform_w = torch.full((c, n), 1.0 / n, device=dev)
    loglike = torch.zeros(c, device=dev)
    dead = torch.zeros(c, dtype=torch.bool, device=dev)
    p_hist, w_hist = [particles], [uniform_w]
    lls, esses, states = [], [n_f], [_weighted_sum(uniform_w, particles)]
    for t in range(ys.shape[0]):
        y_t = ys[t, 0] if ys.shape[1] == 1 else ys[t]
        k_gap, _, _, k_res, _ = step_keys[:, t].unbind(1)
        particles = trans(key=k_gap, particles=particles, t=t + 1, **theta)
        lw = weight(y=y_t, particles=particles, t=t + 1, **theta)
        particles, weights, ess_rec, loglike, dead = old_weight_step(
            lw, particles, k_res, loglike, dead, n_f, log_n, uniform_w, thr,
            always)
        p_hist.append(particles)
        w_hist.append(weights)
        lls.append(loglike)
        esses.append(ess_rec)
        states.append(_weighted_sum(weights, particles))
    return (loglike, torch.stack(lls, dim=1), torch.stack(esses, dim=1),
            torch.stack(p_hist, dim=1), torch.stack(w_hist, dim=1),
            torch.stack(states, dim=1))


def day_case(c, n, d, alive_n, seed, dev="cpu"):
    """Raw log-weights (masked lanes hold anything, +inf and NaN among
    them), a chain whose every weight is below -1e8, a NaN lane, key words
    as a strided view of ``[C, T, 5, 2]`` day keys."""
    gen = torch.Generator().manual_seed(seed)
    alive = torch.full((c,), float(alive_n))
    alive[1] = float(alive_n // 2)
    lane = torch.arange(n, dtype=torch.float32)
    scale = 0.1 + 3.0 * torch.rand((c, 1), generator=gen)
    lw = scale * torch.randn((c, n), generator=gen)
    lw = torch.where(lane < alive[:, None], lw, 50.0)
    lw[1, alive_n // 2:] = float("inf")
    lw[2] = -3e8 + torch.randn(n, generator=gen)      # every weight < -1e8
    lw[3, 5] = float("nan")
    lw[4, -1] = float("nan")                          # past the count
    parts = torch.randn((c, n, d), generator=gen)
    uni = torch.where(lane < alive[:, None], 1.0 / alive[:, None], 0.0)
    rng = np.random.default_rng(seed)
    days = torch.as_tensor(rng.integers(0, 2**32, (c, 7, 5, 2),
                                        dtype=np.uint64).astype(np.int64))
    words = days.to(dev)[:, 3, 3]                     # row stride 70
    loglike = torch.randn(c, generator=gen) * 10.0
    loglike[5] = -math.inf
    dead = torch.zeros(c, dtype=torch.bool)
    dead[5] = True                                    # dead on entry
    return (*(x.to(dev) for x in (lw, parts, uni, alive)), words,
            loglike.to(dev), dead.to(dev))
