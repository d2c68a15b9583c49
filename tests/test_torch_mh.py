"""The port's PMMH sampling phase (bayesssm_tpu_torch/pmmh/driver.py).

``mh_step`` is held to a JAX reconstruction of the JAX PMMH driver's step
(``driver.py:484-518``) built from the JAX package's own transforms,
priors and un-vmapped interpret-mode sweep, fed the same normals,
uniforms and filter key words: the same accept decisions, theta to 1e-6
and loglike to 1e-3 (the SIR sweep's f32 ``lgamma`` offset).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.models.sir import sir_model as j_sir_model
from bayesssm_tpu.ops.sir_sweep_pallas import sir_filter_sweep as j_sir
from bayesssm_tpu.pmmh.priors import sum_log_priors as j_priors
from bayesssm_tpu.pmmh.transforms import (
    back_transform_params as j_back,
    log_jacobian as j_logjac,
    transform_params as j_fwd,
)
from bayesssm_tpu_torch.models.sir import (
    simulate_sir,
    sir_model,
    sir_sweep_pf_impl,
)
from bayesssm_tpu_torch.pmmh.driver import (
    _particle_lane_bound,
    _proposal_factor,
    chain_state_from_numpy,
    init_chain_state,
    mh_step,
    sample_chains,
    step_words,
)
from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

torch.set_num_threads(1)

N_TOTAL, I0, N = 100, 10, 128


@pytest.fixture(scope="module")
def setup():
    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=6)
    y = y.astype(np.float32)
    _, log_priors, transform = sir_model()
    names = list(log_priors)
    pf = sir_sweep_pf_impl(N_TOTAL, I0)(
        y, N, names, None, None, "BPF", "SISAR", "stratified", False,
        max_particles=N,
    )
    return dict(y=y, names=names, pf=pf,
                prior_fns=[log_priors[p] for p in names],
                transforms=resolve_transforms(transform, names))


@pytest.mark.parametrize("convention", ["consistent", "reference"])
def test_mh_step_matches_jax_reconstruction(setup, convention):
    c, p = 4, 2
    rng = np.random.default_rng(11)
    theta = np.array([[0.4, 0.25], [0.5, 0.2], [0.3, 0.3], [0.45, 0.22]],
                     np.float32)
    factor = np.stack([_proposal_factor(np.diag([0.04, 0.01]) +
                                        0.003 * k * np.eye(2))
                       for k in range(c)])
    eps = rng.normal(size=(c, p)).astype(np.float32)
    u_acc = np.array([0.01, 0.5, 0.99, 0.3], np.float32)
    kd = np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                   for k in range(c)])
    ll = np.array([-20.0, -21.0, -19.5, -20.5], np.float32)

    got_theta, got_ll, _, got_acc = mh_step(
        setup["pf"], torch.as_tensor(theta), torch.as_tensor(ll),
        torch.as_tensor(factor), torch.full((c,), float(N)),
        torch.as_tensor(eps), torch.as_tensor(u_acc),
        torch.as_tensor(kd.astype(np.int64)), setup["prior_fns"],
        setup["transforms"], convention,
    )

    _, jlp, _ = j_sir_model(N_TOTAL, I0)
    jprior = [jlp[q] for q in setup["names"]]
    tr = setup["transforms"]
    sweep = jax.jit(lambda w, th: j_sir(
        jax.random.wrap_key_data(w), jnp.asarray(setup["y"]), float(N),
        th[0], th[1], N_TOTAL, I0, interpret=True)[0])
    for k in range(c):
        th = jnp.asarray(theta[k])
        zp = j_fwd(th, tr) + jnp.asarray(factor[k]) @ jnp.asarray(eps[k])
        th_prop = j_back(zp, tr)
        lp_prop = j_priors(th_prop, jprior)
        ll_prop = sweep(jnp.asarray(kd[k]), th_prop)
        log_ratio = (ll_prop + lp_prop + j_logjac(th_prop, tr, convention)
                     ) - (ll[k] + j_priors(th, jprior)
                          + j_logjac(th, tr, convention))
        log_ratio = jnp.where(jnp.isnan(log_ratio) | ~jnp.isfinite(lp_prop),
                              -jnp.inf, log_ratio)
        accept = bool(jnp.log(u_acc[k]) < log_ratio)
        assert bool(got_acc[k]) == accept, k
        want_theta = np.asarray(th_prop if accept else th)
        want_ll = float(ll_prop) if accept else float(ll[k])
        np.testing.assert_allclose(got_theta[k].numpy(), want_theta,
                                   rtol=0, atol=1e-6)
        assert abs(float(got_ll[k]) - want_ll) <= 1e-3
    assert 0 < int(got_acc.sum()) < c   # the case mixes both decisions


def test_chain_state_round_trip():
    rng = np.random.default_rng(0)
    theta = rng.random((3, 2)).astype(np.float32)
    factors = rng.random((3, 2, 2)).astype(np.float32)
    target_n = np.array([100, 128, 64])
    words = np.array([[0, 1], [2**31, 2**32 - 1], [12345, 0x9E3779B9]],
                     np.uint32)
    st = chain_state_from_numpy(theta, factors, target_n, words, "cpu")
    np.testing.assert_array_equal(st.theta.numpy(), theta)
    np.testing.assert_array_equal(st.factors.numpy(), factors)
    np.testing.assert_array_equal(st.n.numpy(), target_n.astype(np.float32))
    assert st.words.dtype == torch.int64
    np.testing.assert_array_equal(st.words.numpy().astype(np.uint32), words)
    assert st.ll is None and st.step == 0
    with pytest.raises(ValueError, match="seed_words"):
        chain_state_from_numpy(theta, factors, target_n, words[:2], "cpu")


def test_sample_chains_is_finite_and_deterministic(setup):
    c = 8
    factors = np.tile(np.diag([0.1, 0.1]).astype(np.float32), (c, 1, 1))

    def run():
        state = init_chain_state([0.4, 0.25], factors, N, 1405, "cpu")
        return sample_chains(setup["pf"], state, 6, 2, setup["prior_fns"],
                             setup["transforms"],
                             return_latent_state_est=True)

    a, b = run(), run()
    assert a.samples.shape == (c, 4, 2) and np.isfinite(a.samples).all()
    assert a.latent.shape == (c, 4, len(setup["y"]) + 1, 2)
    np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_array_equal(a.latent, b.latent)
    assert ((a.acceptance_rate >= 0) & (a.acceptance_rate <= 1)).all()
    assert a.state.step == 5 and np.isfinite(a.state.ll.numpy()).all()
    # Continuing from the returned state starts at its current theta.
    more = sample_chains(setup["pf"], a.state, 2, 0, setup["prior_fns"],
                         setup["transforms"])
    np.testing.assert_array_equal(more.samples[:, 0],
                                  a.state.theta.numpy())
    assert more.state.se is None and more.latent is None
    with pytest.raises(ValueError, match="without state estimates"):
        sample_chains(setup["pf"], more.state, 2, 0, setup["prior_fns"],
                      setup["transforms"], return_latent_state_est=True)


def test_stream_words_and_validation(setup):
    words = torch.tensor([[1, 2], [3, 4]], dtype=torch.int64)
    w0 = step_words(words, 0, 7)
    assert w0.shape == (2, 7) and not torch.equal(w0, step_words(words, 1, 7))
    assert torch.equal(step_words(words[1:], 3, 7)[0],
                       step_words(words, 3, 7)[1])
    assert _particle_lane_bound(100) == 128
    assert _particle_lane_bound(129) == 256
    state = init_chain_state([0.4, 0.25], np.eye(2)[None] * 0.1, N, 0,
                             "cpu")
    for m, burn in ((0, 0), (3, 3), (3, -1)):
        with pytest.raises(ValueError, match="m must|burn_in"):
            sample_chains(setup["pf"], state, m, burn, setup["prior_fns"],
                          setup["transforms"])


def test_sample_chains_through_the_engine():
    """``sample_chains`` over the generic engine (``_make_pf_loglike`` on
    SIR ``gillespie_pallas``): finite, and the same samples for the same
    seed."""
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=5)
    fns, log_priors, transform = sir_model(N_TOTAL, I0,
                                           transition="gillespie_pallas")
    names = list(log_priors)
    pf = _make_pf_loglike(y, N, names, (*fns, None, None), None, "BPF",
                          "SISAR", "stratified", False, max_particles=N)
    prior_fns = [log_priors[q] for q in names]
    transforms = resolve_transforms(transform, names)
    factors = np.tile(np.diag([0.1, 0.1]).astype(np.float32), (4, 1, 1))

    def run(seed):
        state = init_chain_state([0.4, 0.25], factors, N, seed, "cpu")
        return sample_chains(pf, state, 4, 1, prior_fns, transforms)

    a, b, other = run(3), run(3), run(4)
    assert a.samples.shape == (4, 3, 2) and np.isfinite(a.samples).all()
    assert np.isfinite(a.state.ll.numpy()).all()
    np.testing.assert_array_equal(a.samples, b.samples)
    assert not np.array_equal(a.state.ll.numpy(), other.state.ll.numpy())
