"""Plain particle filters on ``[C, N]`` tensors: the whole sweep and the
per-day engine, bootstrap filter, adaptive (SISAR, below half the alive
count) stratified resampling, with masked lanes.

Each chain's numbers depend on its own seed words alone, and every sum
over lanes is a fixed halving tree and the CDF a doubling scan with a
running max, so the filter is exact per chain: the system under test
states the same arithmetic for its kernels, and this file is compared
with its output chain by chain.

``dt`` is the floating type the filter computes in: float32, the
configurations' precision, or a lower one for the control that the
comparison must reject. Draws are made in float32 and cast.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import lowbias, threefry

NEG = -1e30
DEGENERATE = -1e8
SENTINEL = 1.5
MAX_EVENTS = 100_000


class Tally:
    """Work the event loop does: Gillespie events fired, and chain-days."""

    def __init__(self):
        self.fired = 0
        self.chain_days = 0

    def add(self, events, c: int) -> None:
        self.fired += int(events.sum())
        self.chain_days += c


def tree_sum(x):
    """``[C, N] -> [C, 1]`` in halving order; a lane count that is not a
    power of two is padded with zeros."""
    n = x.shape[-1]
    if n & (n - 1):
        pad = (1 << (n - 1).bit_length()) - n
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        n += pad
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:]
    return x


def _shift(x, s: int):
    return torch.cat([torch.zeros_like(x[:, :s]), x[:, :-s]], dim=1)


def running_cdf(w):
    """Hillis-Steele inclusive scan, then a running max."""
    n = w.shape[-1]
    cdf, s = w, 1
    while s < n:
        cdf = cdf + _shift(cdf, s)
        s *= 2
    s = 1
    while s < n:
        cdf = torch.maximum(cdf, _shift(cdf, s))
        s *= 2
    return cdf


def select_index(cdf, pos):
    """``m_k = #{j : cdf_j <= pos_k}``, clamped to the last lane."""
    m = torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=True)
    return m.clamp_(max=cdf.shape[-1] - 1)


def gillespie_day(keys, ctr, s, i, lam_n, gam, t_end, unroll, dt,
                  tally=None):
    """One day of the SIR jump process for every lane: waiting times
    ``-log1p(-u) / rate``, infection when ``u' * rate < rate_inf``,
    ``unroll`` events an iteration, a chain stops when none of its lanes
    is active or after ``MAX_EVENTS`` events; ``ctr [C, 1]`` moves only on
    the iterations in which the chain runs. Returns ``(s, i, ctr)``."""
    tloc = torch.zeros_like(s)
    active = i > 0.0
    steps = torch.zeros_like(ctr)
    events = torch.zeros_like(s, dtype=torch.int64)
    while True:
        go = active.any(dim=1, keepdim=True) & (steps < MAX_EVENTS)
        if not bool(go.any()):
            break
        u = lowbias.uniform_blocks(keys, ctr, 2 * unroll).to(dt)
        for e in range(unroll):
            rate_inf = lam_n * s * i
            rate_tot = rate_inf + gam * i
            dtime = -torch.log1p(-u[2 * e]) * (1.0 / rate_tot)
            t_new = tloc + dtime
            fire = active & go & (t_new <= t_end)
            infect = u[2 * e + 1] * rate_tot < rate_inf
            s = torch.where(fire & infect, s - 1.0, s)
            i = torch.where(fire, torch.where(infect, i + 1.0, i - 1.0), i)
            tloc = torch.where(fire, t_new, tloc)
            active = fire & (i > 0.0)
            events += fire
        ctr = ctr + 2 * unroll * go
        steps = steps + unroll * go
    if tally is not None:
        tally.add(events, s.shape[0])
    return s, i, ctr


class SweepRng:
    """The sweep's lane stream with one draw counter per chain."""

    def __init__(self, keys, dt):
        self.keys = keys
        self.dt = dt
        self.ctr = torch.zeros((keys.shape[0], 1), dtype=torch.int64,
                               device=keys.device)

    def uniform(self):
        u = lowbias.uniform_blocks(self.keys, self.ctr, 1)[0]
        self.ctr = self.ctr + 1
        return u.to(self.dt)


def sweep_filter(model, words, ys, theta, num_particles, lanes: int,
                 dt=torch.float32, tally=None):
    """Log-likelihood ``[C]`` of the whole-sweep bootstrap filter:
    ``model`` gives ``sweep_init(rng, th)``, ``sweep_transition(rng, cols,
    th, t, tally)`` and ``sweep_log_weight(cols, th, y_t)`` over tuples of
    ``[C, N]`` columns; ``ys [T, d_y]``; ``theta [C, P]``;
    ``num_particles [C]`` alive lanes of ``lanes``."""
    c = theta.shape[0]
    n = int(lanes)
    dev = theta.device
    theta = theta.to(dt)
    ys = ys.to(dt)
    alive = num_particles.to(device=dev, dtype=dt).expand(c)[:, None]
    thr = alive / 2.0
    rng = SweepRng(lowbias.lane_keys(words, n), dt)
    th = tuple(theta[:, j:j + 1].expand(c, n) for j in range(theta.shape[1]))
    lane_f = torch.arange(n, dtype=dt, device=dev)[None, :]
    alive_mask = lane_f < alive
    cols = tuple(model.sweep_init(rng, th))
    loglike = torch.zeros((c, 1), dtype=dt, device=dev)
    dead = torch.zeros((c, 1), dtype=torch.bool, device=dev)
    for t in range(ys.shape[0]):
        y_t = (ys[t, 0] if ys.shape[1] == 1
               else tuple(ys[t, j] for j in range(ys.shape[1])))
        cols = tuple(model.sweep_transition(rng, cols, th, t, tally))
        lw = torch.where(alive_mask, model.sweep_log_weight(cols, th, y_t),
                         NEG)
        mx = torch.amax(lw, dim=1, keepdim=True)
        dead = dead | (mx < DEGENERATE)
        shifted = torch.exp(lw - mx)
        ssum = tree_sum(shifted)
        w = shifted / ssum
        ess = 1.0 / tree_sum(w * w)
        loglike = loglike + mx + torch.log(ssum) - torch.log(alive)
        pos = torch.where(alive_mask, (lane_f + rng.uniform()) / alive, 1.0)
        cdf = torch.where(lane_f >= alive - 1.0, SENTINEL, running_cdf(w))
        m = select_index(cdf, pos)
        res = tuple(torch.where(alive_mask, torch.gather(x, -1, m), 0.0)
                    for x in cols)
        do = ess < thr
        cols = tuple(torch.where(do, r, x) for r, x in zip(res, cols))
    return torch.where(dead, -math.inf, loglike)[:, 0].float()


def fused_weight_step(lw, parts, key_words, num_alive, uniform_w, thr):
    """The engine's weight step on ``[C, N]`` log-weights and ``[C, N, d]``
    particles, stratified positions drawn from each chain's key words:
    ``(particles, weights, ess [C], logsumexp [C])``."""
    n = lw.shape[1]
    mx = torch.amax(lw, dim=1, keepdim=True)
    shifted = torch.exp(lw - mx)
    s = tree_sum(shifted)
    w = shifted / s
    ess = (1.0 / tree_sum(w * w))[:, 0]
    lse = (mx + torch.log(s))[:, 0]
    lane = torch.arange(n, device=lw.device)
    last_alive = torch.amax(torch.where(uniform_w > 0.0, lane, 0), dim=1,
                            keepdim=True)
    cdf = torch.where(lane >= last_alive, SENTINEL, running_cdf(w))
    u = lowbias.position_uniforms(key_words, n).to(lw.dtype)
    lane_f = torch.arange(n, dtype=lw.dtype, device=lw.device)
    alive = num_alive[:, None]
    pos = torch.where(lane_f < alive, (lane_f + u) / alive, 1.0)
    m = select_index(cdf, pos)
    res = torch.gather(parts, 1, m[..., None].expand_as(parts))
    do = (ess < thr)[:, None]
    return (torch.where(do[..., None], res, parts),
            torch.where(do, uniform_w, w), ess, lse)


def engine_filter(model, key_words, ys, theta, num_particles, lanes: int,
                  dt=torch.float32, tally=None):
    """Log-likelihood ``[C]`` of the per-day engine's bootstrap filter
    with its fused weight step: ``split(key)`` gives the run and initial
    keys, ``split(run, (T, 5))`` each day's keys (gap, aux, second
    transition, resample, move), of which the bootstrap filter uses the
    first and the fourth. ``model`` gives ``engine_init(key, n, th, dt)``,
    ``engine_transition(key, particles, th, tally)`` and
    ``engine_log_weight(y, particles, th)``; ``th`` holds ``[C]``
    parameters."""
    c = theta.shape[0]
    n = int(lanes)
    dev = theta.device
    theta = theta.to(dt)
    ys = ys.to(dt)
    th = tuple(theta[:, j] for j in range(theta.shape[1]))
    key_run, k_init = threefry.split(key_words).unbind(1)
    particles = model.engine_init(k_init, n, th, dt)
    n_f = num_particles.to(device=dev, dtype=dt).expand(c).contiguous()
    lane = torch.arange(n, dtype=dt, device=dev)
    alive = lane < n_f[:, None]
    log_n = torch.log(n_f)
    thr = n_f / 2.0
    uniform_w = torch.where(alive, 1.0 / n_f[:, None], 0.0)
    step_keys = threefry.split(key_run, (ys.shape[0], 5))
    loglike = torch.zeros(c, dtype=dt, device=dev)
    dead = torch.zeros(c, dtype=torch.bool, device=dev)
    for t in range(ys.shape[0]):
        y_t = ys[t, 0] if ys.shape[1] == 1 else ys[t]
        k_gap, _, _, k_res, _ = step_keys[:, t].unbind(1)
        particles = model.engine_transition(k_gap, particles, th, tally)
        lw = torch.where(alive, model.engine_log_weight(y_t, particles, th),
                         -math.inf)
        dead = dead | (torch.amax(lw, dim=1) < DEGENERATE)
        p3 = particles if particles.ndim == 3 else particles[..., None]
        p3, _, _, lse = fused_weight_step(torch.clamp_min(lw, NEG), p3,
                                          k_res, n_f, uniform_w, thr)
        particles = p3 if particles.ndim == 3 else p3[..., 0]
        loglike = torch.where(dead, -math.inf, loglike + (lse - log_n))
    return loglike.float()
