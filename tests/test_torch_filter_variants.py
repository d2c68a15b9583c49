"""APF and RMPF behaviour in the port's engine, the mirror of
``tests/test_filter_variants.py``: the APF beats the BPF on state MSE under
informative observations, the RMPF beats it under strong degeneracy (over
five seeds, as single seeds are noisy), the RMPF always resamples, the
APF's lookahead changes the result, degenerate aux weights give ``-inf``,
and moves written for one particle run unchanged. Each seed's run is one
chain whose key is ``jax.random.key(seed)``'s words; the model functions
are the engine's batched ones.
"""

import math

import numpy as np
import torch

from bayesssm_tpu_torch.filters import (
    auxiliary_filter,
    bootstrap_filter,
    resample_move_filter,
)
from bayesssm_tpu_torch.ops import threefry

torch.set_num_threads(1)

MU, SIGMA = 1.0, 0.1
THETA = {"mu": MU, "sigma": SIGMA}


def simulate_drift(seed, T=50, sigma=SIGMA):
    rng = np.random.default_rng(seed)
    x = np.zeros(T + 1)
    y = np.zeros(T)
    x[0] = rng.normal()
    for t in range(T):
        x[t + 1] = x[t] + rng.normal(MU)
        y[t] = rng.normal(x[t + 1], sigma)
    return x, y


def key(seed):
    return threefry.key(seed)[None]


def init_fn(key, num_particles):
    return threefry.normal(key, (num_particles,))


def transition_fn(key, particles, mu):
    return particles + mu[:, None] + threefry.normal(key, particles.shape[1:])


def loglik_fn(y, particles, sigma):
    s = sigma[:, None]
    return -0.5 * (torch.log(2 * math.pi * s**2) + ((y - particles) / s) ** 2)


def aux_loglik_fn(y, particles, mu, sigma):
    return loglik_fn(y, particles + mu[:, None], sigma)


def move_fn(key, particles, y, sigma):
    k1, k2 = threefry.split(key).unbind(-2)
    shape = particles.shape[1:]
    proposal = particles + 0.1 * threefry.normal(k1, shape)
    log_alpha = loglik_fn(y, proposal, sigma) - loglik_fn(y, particles, sigma)
    accept = torch.log(threefry.uniform(k2, shape)) < log_alpha
    return torch.where(accept, proposal, particles)


def mse(res, x):
    return np.mean((res.state_est[0].numpy() - x) ** 2)


def test_apf_beats_bpf_mse():
    wins = 0
    for seed in range(5):
        x, y = simulate_drift(seed)
        bpf = bootstrap_filter(key(seed), y, 20, init_fn, transition_fn,
                               loglik_fn, theta=THETA, return_particles=False)
        apf = auxiliary_filter(key(seed + 100), y, 20, init_fn,
                               transition_fn, loglik_fn, aux_loglik_fn,
                               theta=THETA, return_particles=False)
        wins += mse(apf, x) < mse(bpf, x)
    assert wins >= 3


def test_rmpf_beats_bpf_mse():
    wins = 0
    for seed in range(5):
        x, y = simulate_drift(seed, sigma=0.05)
        theta = {"mu": MU, "sigma": 0.05}
        bpf = bootstrap_filter(key(seed), y, 20, init_fn, transition_fn,
                               loglik_fn, theta=theta, return_particles=False)
        rmpf = resample_move_filter(key(seed + 100), y, 20, init_fn,
                                    transition_fn, loglik_fn, move_fn,
                                    theta=theta, return_particles=False)
        wins += mse(rmpf, x) < mse(bpf, x)
    assert wins >= 3


def test_rmpf_always_resamples():
    _, y = simulate_drift(7)
    res = resample_move_filter(key(0), y, 32, init_fn, transition_fn,
                               loglik_fn, move_fn, theta=THETA)
    # SISR is forced: the recorded ESS is always n (Q4).
    np.testing.assert_allclose(res.ess.numpy(), 32.0)
    assert res.algorithm == "RMPF"
    assert res.resample_algorithm == "SISR"


def test_apf_uses_lookahead_weights():
    _, y = simulate_drift(3)
    apf = auxiliary_filter(key(5), y, 64, init_fn, transition_fn, loglik_fn,
                           aux_loglik_fn, theta=THETA, return_particles=False)
    bpf = bootstrap_filter(key(5), y, 64, init_fn, transition_fn, loglik_fn,
                           theta=THETA, return_particles=False)
    assert not np.allclose(apf.state_est.numpy(), bpf.state_est.numpy())
    assert np.isfinite(apf.loglike.numpy()).all()


def test_apf_degenerate_aux_weights_give_neg_inf():
    """Degenerate aux weights kill the chain as degenerate weights do, on
    the portable route and the fused one drawing its own positions (the
    latter's -1e30 clamp must not cancel in ``lw - aux_anc``)."""
    _, y = simulate_drift(3, T=8)

    def bad_aux_fn(y, particles, mu, sigma):
        return torch.full_like(particles, -1.0e12)

    for use_fused in (False, "interpret-inkernel"):
        res = auxiliary_filter(key(5), y, 128, init_fn, transition_fn,
                               loglik_fn, bad_aux_fn, theta=THETA,
                               return_particles=False, use_fused=use_fused)
        ll = float(res.loglike[0])
        assert np.isinf(ll) and ll < 0, (use_fused, ll)


def single_particle_move_fn(key, particle, y, sigma):
    """A reference-style move written for one particle
    (``utils/signatures.py::adapt_move_fn`` runs it under vmap)."""
    k1, k2 = threefry.split(key).unbind(-2)
    proposal = particle + 0.1 * threefry.normal(k1)
    s = sigma
    log_alpha = (-0.5 * ((y - proposal) / s) ** 2
                 + 0.5 * ((y - particle) / s) ** 2)
    accept = torch.log(threefry.uniform(k2)) < log_alpha
    return torch.where(accept, proposal, particle)


def test_single_particle_move_fn_runs_unchanged():
    x, y = simulate_drift(3, sigma=0.05)
    theta = {"mu": MU, "sigma": 0.05}
    res = resample_move_filter(key(11), y, 24, init_fn, transition_fn,
                               loglik_fn, single_particle_move_fn,
                               theta=theta, return_particles=False)
    assert np.isfinite(res.loglike.numpy()).all()
    # The rejuvenated filter still tracks the drifting state.
    assert np.sqrt(mse(res, x)) < 0.5


def test_single_particle_move_deterministic_matches_vectorized():
    _, y = simulate_drift(5)

    def move_vec(particles, y, mu):
        return particles + 0.0 * mu[:, None]

    def move_single(particle, y, mu):
        return particle + 0.0 * mu

    a = resample_move_filter(key(2), y, 16, init_fn, transition_fn,
                             loglik_fn, move_vec, theta=THETA,
                             return_particles=True)
    b = resample_move_filter(key(2), y, 16, init_fn, transition_fn,
                             loglik_fn, move_single, theta=THETA,
                             return_particles=True)
    np.testing.assert_array_equal(a.particles_history.numpy(),
                                  b.particles_history.numpy())
    np.testing.assert_array_equal(a.loglike.numpy(), b.loglike.numpy())


def test_single_particle_move_matrix_state():
    # Matrix particles: the move gets each ROW (the reference's
    # particles[j, ]).
    _, y = simulate_drift(9)

    def init2(key, num_particles):
        return threefry.normal(key, (num_particles, 2))

    def trans2(key, particles, mu):
        return (particles + mu[:, None, None]
                + threefry.normal(key, particles.shape[1:]))

    def loglik2(y, particles, sigma):
        s = sigma[:, None]
        return -0.5 * (torch.log(2 * math.pi * s**2)
                       + ((y - particles[..., 0]) / s) ** 2)

    rows_seen = []

    def move_single(key, particle, y):
        rows_seen.append(tuple(particle.shape))
        return particle + 0.01 * threefry.normal(key, particle.shape)

    res = resample_move_filter(key(4), y, 16, init2, trans2, loglik2,
                               move_single, theta=THETA)
    assert np.isfinite(res.loglike.numpy()).all()
    assert rows_seen and all(s == (2,) for s in rows_seen)
