"""The system under test's filter of bayesSSM's README model: the per-day
engine (``_make_pf_loglike``) with the model's threefry normals and K3
once a day; bootstrap filter, SISAR, stratified, as ``pmmh()`` builds it
with no ``pf_impl``.
"""

from __future__ import annotations


def build(cfg: dict, path: str, y, particles: int, lanes: int):
    """``(pf, prior_fns)`` in ``("phi", "sigma_x", "sigma_y")`` order."""
    from bayesssm_tpu_torch.models.sinusoidal import sinusoidal_model
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    del cfg
    if path != "engine":
        raise ValueError(f"unknown sinusoidal filter path {path!r}")
    fns, log_priors, _ = sinusoidal_model()
    names = list(log_priors)
    pf = _make_pf_loglike(y, particles, names, (*fns, None, None), None,
                          "BPF", "SISAR", "stratified", False,
                          max_particles=lanes)
    return pf, [log_priors[q] for q in names]
