"""Stochastic SIR epidemic model (port of ``bayesssm_tpu/models/sir.py``).

Closed population of ``n_total``; latent state (S, I); infection rate
lam / n_total * S * I, removal rate gamma * I; observation
``Y_t ~ Pois(I(t))`` at integer times. Priors lam ~ HalfNormal(1),
gamma ~ HalfNormal(2), both log-transformed.

Two filters run it: the generic engine (``filters/core.py``) with the
model functions of :func:`sir_model`, whose transition is the per-day
Gillespie step (``ops/gillespie.py``, kernel K4) or binomial tau-leaping
(:func:`tau_leap_step`, plain PyTorch, as the JAX package computes it
outside any kernel), and the whole-sweep op (``ops/sir_sweep.py``, kernel
K1) behind :func:`sir_sweep_pf_impl`.
:func:`sir_aux_log_likelihood_fn` (APF) and :func:`sir_move_fn` (RMPF)
are the engine's model functions of the two other filters.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesssm_tpu_torch.models.distributions import (
    halfnorm_logpdf,
    pois_logpmf,
)
from bayesssm_tpu_torch.ops import threefry

__all__ = ["sir_model", "sir_sweep_pf_impl", "sir_aux_log_likelihood_fn",
           "sir_move_fn", "simulate_sir", "tau_leap_step"]

TRANSITIONS = ("gillespie", "gillespie_pallas", "tauleap")


def sir_model(
    n_total: int = 500,
    init_infected: int = 70,
    transition: str = "gillespie",
    substeps: int = 10,
    pallas_interpret: bool = False,
):
    """``(model_fns, log_priors, param_transform)`` for the SIR model, with
    the JAX function's signature and return value; ``model_fns`` is
    ``(init_fn, transition_fn, log_likelihood_fn)`` written for the engine
    (``filters/core.py``: ``key [C, 2]``, particles ``[C, N, 2]``, ``lam``
    and ``gamma`` ``[C]``).

    ``transition``:

    * ``"gillespie_pallas"`` — the exact jump process through the per-day
      step ``ops/gillespie.py`` (its CUDA kernel on the card), drawing the
      JAX kernel's stream: it agrees with the JAX ``"gillespie_pallas"``
      per key;
    * ``"gillespie"`` — the same op. The JAX ``"gillespie"`` re-keys its
      loop onto an ``rbg`` generator that cannot be matched key by key, so
      the two agree in distribution only;
    * ``"tauleap"`` — :func:`tau_leap_step` with ``substeps`` leaps a day,
      drawing the JAX function's binomials per key.

    ``pallas_interpret`` is accepted and ignored: the port picks the
    implementation by device (the plain version for CPU tensors, the
    kernel for CUDA tensors).
    """
    del pallas_interpret
    if transition not in TRANSITIONS:
        raise ValueError(
            "transition must be 'gillespie', 'gillespie_pallas' or 'tauleap'"
        )
    from bayesssm_tpu_torch.ops.gillespie import gillespie_step

    s0 = float(n_total - init_infected)
    i0 = float(init_infected)

    def init_fn(key, num_particles):
        c = key.shape[0]
        return torch.stack([
            torch.full((c, num_particles), s0, device=key.device),
            torch.full((c, num_particles), i0, device=key.device),
        ], dim=-1)

    if transition == "tauleap":
        def transition_fn(key, particles, lam, gamma):
            return tau_leap_step(key, particles, lam, gamma, float(n_total),
                                 substeps)
    else:
        def transition_fn(key, particles, lam, gamma):
            return gillespie_step(key, particles, lam, gamma, float(n_total))

    def log_likelihood_fn(y, particles):
        return pois_logpmf(y, particles[..., 1])

    log_priors = {
        "lam": lambda v: halfnorm_logpdf(v, 1.0),
        "gamma": lambda v: halfnorm_logpdf(v, 2.0),
    }
    param_transform = {"lam": "log", "gamma": "log"}
    return ((init_fn, transition_fn, log_likelihood_fn), log_priors,
            param_transform)


def tau_leap_step(key, state, lam, gamma, n_total, substeps: int = 10):
    """One approximate SIR day by binomial tau-leaping (the JAX
    ``tau_leap_step``): ``substeps`` leaps of ``dt = 1 / substeps``, with
    Binomial(S, 1 - exp(-lam I / n_total dt)) infections and
    Binomial(I, 1 - exp(-gamma dt)) removals per leap.

    ``key [C, 2]``, ``state [C, N, 2]`` (S, I), ``lam`` and ``gamma`` ``[C]``.
    Each chain's draws are the JAX function's for its key: leap ``j``
    takes ``split(key, substeps)[j]`` and splits it into the infection and
    removal keys. The two binomials of a leap run as one batch, and the
    day's binomial loops share one chain of key splits
    (``threefry.LoopKeys``), since the keys do not depend on the state.
    """
    c = key.shape[0]
    dt = 1.0 / substeps
    leap_keys = threefry.split(threefry.split(key, substeps))  # [C, S, 2, 2]
    flat = leap_keys.reshape(-1, 2)
    loops = (threefry.LoopKeys(flat, 2, 1), threefry.LoopKeys(flat, 3, 0))
    # Row (chain, leap, draw) of the day's keys, for each leap.
    rows = torch.arange(flat.shape[0], device=key.device).reshape(
        c, substeps, 2)
    s, i = state[..., 0], state[..., 1]
    p_rem = (-torch.expm1(-gamma * dt))[:, None].expand_as(i)
    for j in range(substeps):
        p_inf = -torch.expm1(-(lam[:, None] / n_total) * i * dt)
        row_map = rows[:, j].reshape(-1)
        draws = threefry.binomial(
            leap_keys[:, j], torch.stack([s, i], dim=1),
            torch.stack([p_inf, p_rem], dim=1),
            loops=tuple(loop.rows(row_map) for loop in loops))
        n_inf, n_rem = draws[:, 0], draws[:, 1]
        s = s - n_inf
        i = torch.clamp_min(i + n_inf - n_rem, 0.0)
    return torch.stack([s, i], dim=-1)


def sir_sweep_pf_impl(n_total: int = 500, init_infected: int = 70,
                      unroll: int = 8, move_step_max: int = 2):
    """PMMH ``pf_impl`` factory routing the SIR filter through the
    whole-sweep op: BPF, APF (the Poisson weight as the lookahead) or RMPF
    (the ``+-move_step_max`` move on I); SIS, SISR or SISAR (RMPF forces
    SISR); stratified or systematic; ``obs_times`` as a gap loop in the
    day. The JAX ``sir_builder_pf_impl``.

    Usage: ``pf = sir_sweep_pf_impl(500, 70)(y, 128, ["lam", "gamma"],
    None, None, "BPF", "SISAR", "stratified", False, max_particles=128)``
    then ``pf(seed_words [C, 2], theta [C, 2], n)``.
    """
    from bayesssm_tpu_torch.ops.sir_sweep import sir_sweep_parts
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    parts = sir_sweep_parts(n_total, init_infected, unroll=unroll,
                            move_step_max=move_step_max)
    return build_sweep_pf_impl(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        ("lam", "gamma"), aux_log_weight_fn=parts["aux_log_weight_fn"],
        move_fn=parts["move_fn"], num_obs_cols=2,
        obs_transform=parts["obs_transform"], kernel=parts["kernel"],
    )


def sir_aux_log_likelihood_fn(y, particles):
    """APF lookahead weights for the SIR model: the observation density at
    the propagated infectious count, the same Poisson term as the weight
    function (the reference evaluates the aux weights after the gap loop,
    quirk Q2)."""
    return pois_logpmf(y, particles[..., 1])


def sir_move_fn(n_total: int = 500, step_max: int = 2):
    """RMPF rejuvenation move for SIR, an engine model function: propose
    ``I' = I + U{-step_max..step_max}`` with S fixed and accept it with the
    Poisson observation-likelihood ratio; proposals outside
    ``[0, n_total - S]`` are rejected. Each chain draws ``randint`` and then
    ``uniform`` over its particles from the two halves of ``split(key)``,
    as the JAX function does."""

    def move_fn(key, particles, y, lam, gamma):
        del lam, gamma  # the observation conditional is theta-free
        s = particles[..., 0]
        i = particles[..., 1]
        k_step, k_acc = threefry.split(key).unbind(-2)
        n = i.shape[-1]
        step = threefry.randint(k_step, (n,), -step_max,
                                step_max + 1).to(i.dtype)
        i_prop = i + step
        in_support = (i_prop >= 0.0) & (i_prop <= float(n_total) - s)
        log_ratio = (pois_logpmf(y, torch.clamp_min(i_prop, 0.0))
                     - pois_logpmf(y, i))
        u = threefry.uniform(k_acc, (n,))
        accept = in_support & (torch.log(u) < log_ratio)
        return torch.stack([s, torch.where(accept, i_prop, i)], dim=-1)

    return move_fn


def simulate_sir(seed=1405, n_total=500, init_infected=70, t_max=10,
                 lam=0.5, gamma=0.2):
    """Host-side exact simulation of one epidemic + Poisson observations:
    ``(states [t_max, 2], y [t_max])``, the same draws as the JAX
    package's ``simulate_sir`` for the same seed."""
    rng = np.random.default_rng(seed)
    s = float(n_total - init_infected)
    i = float(init_infected)
    states = np.zeros((t_max, 2))
    for t in range(t_max):
        tt = 0.0
        while i > 0:
            rate_inf = lam / n_total * s * i
            rate_tot = rate_inf + gamma * i
            if rate_tot <= 0:
                break
            dt = rng.exponential(1.0 / rate_tot)
            if tt + dt > 1.0:
                break
            tt += dt
            if rng.uniform() < rate_inf / rate_tot:
                s -= 1.0
                i += 1.0
            else:
                i -= 1.0
        states[t] = (s, i)
    y = rng.poisson(states[:, 1])
    return states, y.astype(np.float64)
