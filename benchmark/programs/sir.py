"""The system under test's SIR filters, built from a configuration.

``sweep``: ``sir_sweep_pf_impl``, the whole sweep in one kernel (K1) a
step. ``engine``: the per-day engine (``_make_pf_loglike``) with the
``gillespie_pallas`` transition, K4 and K3 once a day each. Both are the
bootstrap filter with SISAR stratified resampling, as ``pmmh()`` builds
them.
"""

from __future__ import annotations


def build(cfg: dict, path: str, y, particles: int, lanes: int):
    """``(pf, prior_fns)``: ``pf(seed_words [C, 2], theta [C, 2], n)``
    and the program's priors in ``("lam", "gamma")`` order."""
    from bayesssm_tpu_torch.models.sir import sir_model, sir_sweep_pf_impl
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    n_total, i0 = cfg["n_total"], cfg["init_infected"]
    fns, log_priors, _ = sir_model(n_total, i0, transition="gillespie_pallas")
    names = ["lam", "gamma"]
    if path == "sweep":
        factory, model_fns = sir_sweep_pf_impl(n_total, i0), None
    elif path == "engine":
        factory, model_fns = _make_pf_loglike, (*fns, None, None)
    else:
        raise ValueError(f"unknown SIR filter path {path!r}")
    pf = factory(y, particles, names, model_fns, None, "BPF", "SISAR",
                 "stratified", False, max_particles=lanes)
    return pf, [log_priors[q] for q in names]


def pmmh_model(cfg: dict, path: str):
    """``(model_fns, log_priors, pf_impl)`` of the public ``pmmh()`` call:
    the engine's SIR functions and priors, and ``sir_sweep_pf_impl`` on the
    ``sweep`` path (``None``, the engine, on ``engine``)."""
    from bayesssm_tpu_torch.models.sir import sir_model, sir_sweep_pf_impl

    n_total, i0 = cfg["n_total"], cfg["init_infected"]
    fns, log_priors, _ = sir_model(n_total, i0, transition="gillespie_pallas")
    if path not in ("sweep", "engine"):
        raise ValueError(f"unknown SIR filter path {path!r}")
    pf_impl = sir_sweep_pf_impl(n_total, i0) if path == "sweep" else None
    return tuple(fns), log_priors, pf_impl
