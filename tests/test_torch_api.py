"""The port's public surface against the JAX package's, the mirror of
``tests/test_api.py``: the lazy exports, ``FilterConfig`` and
``MeshConfig`` with their messages, ``particle_filter_core(config=)``,
the unknown-attribute error and ``SSM``'s adapted transition
(``tests/test_torch_diagnostics.py`` covers the rest of ``SSM``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesssm_tpu
import bayesssm_tpu_torch
from bayesssm_tpu_torch.ops import threefry

torch.set_num_threads(1)


def test_public_exports_cover_the_jax_package():
    # The reference NAMESPACE (NAMESPACE:3-11) and the JAX package's
    # lazy exports: every one exists in the port, and is callable where
    # JAX's is.
    assert set(bayesssm_tpu.__all__) <= set(bayesssm_tpu_torch.__all__)
    for name in bayesssm_tpu.__all__:
        assert callable(getattr(bayesssm_tpu_torch, name)) == callable(
            getattr(bayesssm_tpu, name)), name
    # Every declared lazy export resolves.
    for name in bayesssm_tpu_torch.__all__:
        getattr(bayesssm_tpu_torch, name)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_filter_config_matches_jax():
    kw = dict(resample_fn="systematic")
    assert (bayesssm_tpu_torch.FilterConfig(**kw).kwargs()
            == bayesssm_tpu.FilterConfig(**kw).kwargs())
    for bad in (dict(algorithm="nope"), dict(resample_fn="nope"),
                dict(resample_algorithm="nope"), dict(threshold=-1.0),
                dict(max_particles=0)):
        assert (_message(lambda: bayesssm_tpu_torch.FilterConfig(**bad))
                == _message(lambda: bayesssm_tpu.FilterConfig(**bad))), bad


def test_mesh_config_matches_jax():
    import torch.distributed as dist

    had_group = dist.is_initialized()
    try:
        mesh = bayesssm_tpu_torch.MeshConfig().build("cpu")
        assert mesh.mesh_dim_names == ("chains", "particles")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
    bad = dict(n_devices=3, particle_axis_size=2)
    assert (_message(lambda: bayesssm_tpu_torch.MeshConfig(**bad).build())
            == _message(lambda: bayesssm_tpu.MeshConfig(**bad).build(
                jax.devices())))
    for fields in (dict(particle_axis_size=0), dict(n_devices=0),
                   dict(chain_axis="x", particle_axis="x")):
        assert (_message(lambda: bayesssm_tpu_torch.MeshConfig(**fields))
                == _message(lambda: bayesssm_tpu.MeshConfig(**fields)))


def test_config_supplies_the_filter_options():
    def init_fn(key, num_particles):
        return threefry.normal(key, (num_particles,))

    def transition_fn(key, particles):
        return particles

    def log_likelihood_fn(y, particles):
        return -0.5 * (y - particles) ** 2

    res = bayesssm_tpu_torch.particle_filter_core(
        threefry.key(0)[None], np.zeros(3), 16, init_fn, transition_fn,
        log_likelihood_fn,
        config=bayesssm_tpu_torch.FilterConfig(
            resample_algorithm="SISR", return_particles=False,
            use_fused=False))
    assert res.particles_history is None
    assert res.resample_algorithm == "SISR"
    # The same call in JAX: the same log-likelihood (one key, no
    # randomness left after the shared draws).
    want = bayesssm_tpu.particle_filter_core(
        jax.random.key(0), jnp.zeros(3), 16,
        lambda key, num_particles: jax.random.normal(key, (num_particles,)),
        lambda key, particles: particles,
        lambda y, particles: -0.5 * (y - particles) ** 2,
        config=bayesssm_tpu.FilterConfig(
            resample_algorithm="SISR", return_particles=False,
            use_fused=False))
    np.testing.assert_allclose(res.loglike.numpy()[0], float(want.loglike),
                               rtol=0, atol=1e-4)


def test_unknown_attr_raises():
    with pytest.raises(AttributeError):
        bayesssm_tpu_torch.not_a_thing


def test_ssm_adapted_transition():
    def init_fn(key, num_particles):
        return threefry.normal(key, (num_particles,))

    def transition_fn(key, particles, mu):
        return particles + mu

    def log_likelihood_fn(y, particles, sigma):
        return -((y - particles) / sigma) ** 2

    ssm = bayesssm_tpu_torch.SSM(init_fn, transition_fn, log_likelihood_fn)
    init, trans, loglik, aux, move = ssm.adapted()
    assert aux is None and move is None
    keys = threefry.key(0)[None]
    p = init(key=keys, num_particles=4, mu=1.0, sigma=0.5)
    assert p.shape == (1, 4)
    out = trans(key=keys, particles=p, t=1, mu=1.0, sigma=0.5)
    np.testing.assert_allclose(out.numpy(), p.numpy() + 1.0)
    ssm.check_params_match({"mu": 1.0, "sigma": 0.5}, {"mu": 1, "sigma": 1})
