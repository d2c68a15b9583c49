"""The system under test's Lotka-Volterra filter under exact Gillespie
simulation, built as a user builds it: three ``torch`` callbacks given to
the public ``build_sweep_pf_impl`` factory with two state and two
observation columns, one transition an observation. The callbacks run
their own event loops through ``rng.event_loop``, so that on the card
they run as the functor generated from them, each lane looping on its own
inside K1. Bootstrap filter, SISAR, stratified, as ``pmmh()`` builds it
with this ``pf_impl``.

The model (``reference/lvssa.py`` has its equations): prey birth, predation
and predator death with hazards ``h = (c1 x1, c2 x1 x2, c3 x2)``; one
event a loop iteration, a waiting time ``-log1p(-u0) / h0`` taken off the
time left and a reaction chosen by ``u1 h0``; the interval ends when the
time left is used up or ``h0 = 0``. The start draws each species by
counting unit-rate arrivals below its mean (a Poisson draw). The
observation density is ``programs/lv.py``'s two-column Gaussian.
"""

from __future__ import annotations

import torch

from benchmark.programs.lv import OBS_SD, lv_log_weight

PARAMS = ("c1", "c2", "c3")
DELTA = 2.0                  # time units between observations
X0_MEAN = (50.0, 100.0)      # the Poisson start's means
MAX_ITERS = 100_000          # a chain's iterations an interval, at most


def _poisson(rng, mean: float, like):
    """A Poisson(``mean``) count a lane: arrivals of unit rate, at times
    ``s += -log1p(-u)``, counted while they fall below ``mean``."""
    def running(carry):
        return carry[1] < mean

    def arrive(u, carry):
        n, s = carry
        s = s - torch.log1p(-u[0])
        return torch.where(s < mean, n + 1.0, n), s

    zero = torch.zeros_like(like)
    n, _ = rng.event_loop(running, arrive, (zero, zero), draws=1,
                          max_iters=MAX_ITERS)
    return n


def lvssa_init(rng, theta):
    return (_poisson(rng, X0_MEAN[0], theta[0]),
            _poisson(rng, X0_MEAN[1], theta[0]))


def lvssa_transition(rng, cols, theta, t):
    """``DELTA`` time units of the exact jump process; ``t`` is unused."""
    c1, c2, c3 = theta

    def hazards(x1, x2):
        """``(h1, h1 + h2, h0)``."""
        h1 = c1 * x1
        h12 = h1 + c2 * x1 * x2
        return h1, h12, h12 + c3 * x2

    def running(carry):
        x1, x2, r = carry
        return (r > 0.0) & (hazards(x1, x2)[2] > 0.0)

    def event(u, carry):
        x1, x2, r = carry
        h1, h12, h0 = hazards(x1, x2)
        r = r + torch.log1p(-u[0]) / h0
        fire = r > 0.0
        v = u[1] * h0
        birth = fire & (v < h1)
        predation = fire & (v >= h1) & (v < h12)
        death = fire & (v >= h12)
        x1 = torch.where(birth, x1 + 1.0,
                         torch.where(predation, x1 - 1.0, x1))
        x2 = torch.where(predation, x2 + 1.0,
                         torch.where(death, x2 - 1.0, x2))
        return x1, x2, r

    x1, x2 = cols
    x1, x2, _ = rng.event_loop(running, event,
                               (x1, x2, torch.full_like(x1, DELTA)),
                               draws=2, max_iters=MAX_ITERS)
    return x1, x2


def lvssa_pf_impl():
    """The ``pf_impl`` factory of the callbacks above."""
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    return build_sweep_pf_impl(
        num_state_cols=2,
        init_fn=lvssa_init,
        transition_fn=lvssa_transition,
        log_weight_fn=lv_log_weight,
        param_names=PARAMS,
        num_obs_cols=2,
    )


def build(cfg: dict, path: str, y, particles: int, lanes: int):
    """``(pf, prior_fns)``: ``pf(seed_words [C, 2], theta [C, 3], n)``
    and the priors ``c1 ~ Exp(1)``, ``c2 ~ Exp(100)``, ``c3 ~ Exp(1)`` in
    ``PARAMS`` order (``programs/lv.py``'s)."""
    from bayesssm_tpu_torch.models.distributions import exp_logpdf

    if path != "sweep":
        raise ValueError(f"unknown LV-SSA filter path {path!r}")
    stated = (cfg["obs_interval"], tuple(cfg["x0_mean"]), cfg["obs_sd"],
              cfg["max_iters"])
    if stated != (DELTA, X0_MEAN, OBS_SD, MAX_ITERS):
        raise ValueError(f"the LV-SSA callbacks take obs_interval, x0_mean, "
                         f"obs_sd, max_iters = "
                         f"{(DELTA, X0_MEAN, OBS_SD, MAX_ITERS)}; the "
                         f"configuration states {stated}")
    pf = lvssa_pf_impl()(y, particles, list(PARAMS), None, None, "BPF",
                         "SISAR", "stratified", False, max_particles=lanes)
    priors = [lambda c: exp_logpdf(c, 1.0), lambda c: exp_logpdf(c, 100.0),
              lambda c: exp_logpdf(c, 1.0)]
    return pf, priors
