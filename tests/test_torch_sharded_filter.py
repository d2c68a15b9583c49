"""The port's particle-sharded filter (``parallel/sharded.py`` and the
engine's ``particle_axis``) on two gloo ranks, against the JAX package's
``sharded_particle_filter`` on the 8-device CPU mesh and against the
Kalman value: the mirror of ``tests/test_sharded_filter.py``.

Every case of the module runs in one two-rank session
(``tests/_torch_dist.py``); the ranks import only the port. A chain's
draws derive from ``fold_in(root, chain id)`` and the shard index, never
from the chain layout, so the port's (1 x 2) layout equals JAX's (4 x 2)
mesh per key: log-likelihoods and state estimates within 1e-4 (float32
sums in another order) on at least 99% of chains. Both ranks of a
particle group return the same bits.

Four variants resample from weights with more float32 rounding between
the two libraries (multinomial's unsorted positions, ``carry_weights``'
weights carried through ``log``, the APF's two resamples a day, the
RMPF's accept tests), and a position within an ulp of a CDF step then
picks another ancestor now and then. The UNSHARDED engine's share of
chains that agree with JAX per key, and the 1-2 ulp CDF difference behind
each flip, are held by ``tests/test_torch_engine_flips.py`` (512 keys a
variant). Against the sharded JAX filter the sharded port disagreed on
6, 4, 8 and 9 of 512 chains (multinomial, carry-weights, APF, RMPF; 128
lanes, T = 20), as often as the unsharded engine does, so the sharding
adds no disagreement of its own. Those four are held to 96% of chains.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from bayesssm_tpu.models.lgss import lgss_model as j_lgss_model
from bayesssm_tpu.parallel.mesh import make_chain_mesh as j_make_chain_mesh
from bayesssm_tpu.parallel.sharded import (
    sharded_particle_filter as j_sharded_particle_filter,
)
from bayesssm_tpu_torch.filters import auxiliary_filter
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.utils.kalman import kalman_loglik

torch.set_num_threads(1)

A, C, SX, SY = td.LGSS_A, 1.0, td.LGSS_SX, td.LGSS_SY
_, Y = simulate_lgss(1405, t_val=20, a=A, sigma_x=SX, sigma_y=SY)
X_LONG, Y_LONG = simulate_lgss(9, t_val=30, a=A, sigma_x=SX, sigma_y=SY)
X_RM, Y_RM = simulate_lgss(21, t_val=25, a=A, sigma_x=SX, sigma_y=SY)
TOL, SHARE = 1e-4, 0.99
# Variants with the unsharded engine's own flip rate against JAX (module
# docstring; tests/test_torch_engine_flips.py holds that rate).
ROUNDING_SHARE = {"sisr-multinomial": 0.96, "carry-weights": 0.96,
                  "apf": 0.96, "rmpf": 0.96}
KEY_CHAINS, KEY_PARTICLES = 128, 128
OBS_TIMES = [1, 3, 4, 7]


def _gapped_obs():
    """Observations at ``OBS_TIMES`` and their exact Kalman value (the JAX
    test's construction)."""
    rng = np.random.default_rng(11)
    x, ys, t_now = rng.normal(), [], 0
    for t in OBS_TIMES:
        for _ in range(t - t_now):
            x = A * x + SX * rng.normal()
        t_now = t
        ys.append(C * x + SY * rng.normal())
    ys = np.asarray(ys, dtype=np.float64)
    mean, var, truth, t_prev = 0.0, 1.0, 0.0, 0
    for j, t in enumerate(OBS_TIMES):
        for _ in range(t - t_prev):
            mean, var = A * mean, A * A * var + SX ** 2
        t_prev = t
        s = C * C * var + SY ** 2
        truth += -0.5 * (math.log(2 * math.pi * s)
                         + (ys[j] - C * mean) ** 2 / s)
        gain = var * C / s
        mean = mean + gain * (ys[j] - C * mean)
        var = (1 - gain * C) * var
    return ys, truth


Y_GAP, GAP_TRUTH = _gapped_obs()

# Per-key variants: (keyword arguments of both filters, observations).
VARIANTS = {
    "bpf-sisar-systematic": ({}, Y),
    "sisr-stratified": (dict(resample_algorithm="SISR",
                             resample_fn="stratified"), Y),
    "sisr-multinomial": (dict(resample_algorithm="SISR",
                              resample_fn="multinomial"), Y),
    "sisr-metropolis": (dict(resample_algorithm="SISR",
                             resample_fn="metropolis"), Y),
    "sis": (dict(resample_algorithm="SIS"), Y),
    "carry-weights": (dict(carry_weights=True), Y),
    "apf": (dict(algorithm="APF", resample_algorithm="SISR"), Y),
    "rmpf": (dict(algorithm="RMPF"), Y_RM),
    "gaps": (dict(obs_times=OBS_TIMES, resample_algorithm="SISR"), Y_GAP),
}


def _cases():
    cases = [
        ("shapes", td.lgss_sharded, dict(y=Y)),
        ("kalman", td.lgss_sharded,
         dict(y=Y, num_chains=48, num_particles=1024,
              resample_algorithm="SISR")),
        ("layout_2x1", td.lgss_sharded,
         dict(y=Y, mesh_shape=(2, 1), seed=3, resample_algorithm="SISR")),
        ("layout_1x2", td.lgss_sharded,
         dict(y=Y, mesh_shape=(1, 2), seed=3, resample_algorithm="SISR")),
        ("track", td.lgss_sharded,
         dict(y=Y_LONG, seed=5, num_chains=4, num_particles=512,
              resample_algorithm="SISR")),
        ("apf", td.lgss_sharded,
         dict(y=Y, num_chains=32, num_particles=512, algorithm="APF",
              resample_algorithm="SISR")),
        ("rmpf", td.lgss_sharded,
         dict(y=Y_RM, seed=2, num_chains=4, num_particles=256,
              algorithm="RMPF")),
        ("gaps", td.lgss_sharded,
         dict(y=Y_GAP, num_chains=32, num_particles=512,
              obs_times=OBS_TIMES, resample_algorithm="SISR")),
        ("masked", td.lgss_masked_core, dict(y=Y)),
        ("chains_3", td.error_text,
         dict(fn=td.lgss_sharded, y=Y, mesh_shape=(2, 1), num_chains=3)),
        ("particles_101", td.error_text,
         dict(fn=td.lgss_sharded, y=Y, num_particles=101)),
        ("bad_algorithm", td.error_text,
         dict(fn=td.lgss_sharded, y=Y, resample_algorithm="X")),
        ("bad_fn", td.error_text,
         dict(fn=td.lgss_sharded, y=Y, resample_fn="X")),
    ]
    for method in ("systematic", "stratified", "multinomial", "metropolis"):
        cases.append((f"unbiased_{method}", td.lgss_sharded,
                      dict(y=Y, num_chains=32, num_particles=512,
                           resample_algorithm="SISR", resample_fn=method)))
    for name, (kw, y) in VARIANTS.items():
        cases.append((f"key_{name}", td.lgss_sharded,
                      dict(y=y, seed=17, num_chains=KEY_CHAINS,
                           num_particles=KEY_PARTICLES, **kw)))
    cases.append(("key_chains_mesh", td.lgss_sharded,
                  dict(y=Y, mesh_shape=(2, 1), seed=17,
                       num_chains=KEY_CHAINS, num_particles=KEY_PARTICLES)))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run_session(2, _cases(), tmp_path_factory.mktemp("ranks"))


def result(ranks, name):
    """Rank 0's result, after checking that rank 1 holds the same bits."""
    r0, r1 = ranks[name]
    if isinstance(r0, tuple):
        for a, b in zip(r0, r1):
            np.testing.assert_array_equal(a, b)
    else:
        assert r0 == r1
    return r0


def j_aux_fn(y, particles, a):
    return -0.5 * (jnp.log(2 * jnp.pi * td.SY_AUX ** 2)
                   + ((y - a * particles) / td.SY_AUX) ** 2)


def j_move_fn(key, particles, y, sigma_y):
    loglik = j_lgss_model()[0][2]
    k1, k2 = jax.random.split(key)
    prop = particles + td.MOVE_SD * jax.random.normal(k1, particles.shape)
    logr = loglik(y, prop, sigma_y=sigma_y) - loglik(y, particles,
                                                     sigma_y=sigma_y)
    accept = jnp.log(jax.random.uniform(k2, particles.shape)) < logr
    return jnp.where(accept, prop, particles)


def jax_sharded(y, mesh_shape, seed, num_chains, num_particles,
                algorithm="BPF", **kw):
    extra = {}
    if algorithm == "APF":
        extra["aux_log_likelihood_fn"] = j_aux_fn
    elif algorithm == "RMPF":
        extra["move_fn"] = j_move_fn
    mesh = j_make_chain_mesh(8, particle_axis_size=mesh_shape[1])
    theta = {k: jnp.asarray(v) for k, v in td.lgss_theta(num_chains).items()}
    ll, states = j_sharded_particle_filter(
        jax.random.key(seed), y, num_particles, *j_lgss_model()[0], theta,
        num_chains=num_chains, mesh=mesh, algorithm=algorithm, **extra,
        **kw)
    return np.asarray(ll), np.asarray(states)


def assert_per_key(got, want, share=SHARE):
    for g, w, what in zip(got, want, ("loglike", "state_est")):
        assert g.shape == w.shape, what
        close = np.abs(g - w) <= TOL
        per_chain = close.reshape(close.shape[0], -1).all(axis=1)
        assert per_chain.mean() >= share, (what, per_chain.mean())


# ---- the tests of tests/test_sharded_filter.py --------------------------

def test_runs_and_shapes(ranks):
    ll, states = result(ranks, "shapes")
    assert ll.shape == (8,)
    assert states.shape == (8, len(Y), 1)
    assert np.isfinite(ll).all()


def test_unbiased_vs_kalman_under_sharding(ranks):
    truth = kalman_loglik(Y, A, C, SX, SY)
    lls = result(ranks, "kalman")[0].astype(np.float64)
    assert abs(lls.mean() - truth) < 0.2
    assert lls.std() < 1.0


def test_placement_independent_rng(ranks):
    ll21 = result(ranks, "layout_2x1")[0]
    ll12 = result(ranks, "layout_1x2")[0]
    for ll in (ll21, ll12):
        assert np.isfinite(ll).all()
    assert abs(ll21.mean() - ll12.mean()) < 1.0


@pytest.mark.parametrize(
    "method", ["systematic", "stratified", "multinomial", "metropolis"])
def test_resamplers_all_unbiased(ranks, method):
    truth = kalman_loglik(Y, A, C, SX, SY)
    lls = result(ranks, f"unbiased_{method}")[0].astype(np.float64)
    assert abs(lls.mean() - truth) < 0.35


def test_state_estimates_track_truth(ranks):
    states = result(ranks, "track")[1]
    est = states[:, :, 0].mean(axis=0)
    assert np.sqrt(np.mean((est - X_LONG[1:]) ** 2)) < 0.5


def test_divisibility_errors(ranks):
    for name in ("chains_3", "particles_101"):
        assert "divide" in result(ranks, name)
    assert "SIS, SISR or SISAR" in result(ranks, "bad_algorithm")
    assert result(ranks, "bad_fn") == "unknown resample_fn"


def test_sharded_apf_matches_unsharded_distribution(ranks):
    ll_sharded = result(ranks, "apf")[0].astype(np.float64)
    keys = threefry.split(threefry.key(100), 16)
    ll_plain = auxiliary_filter(
        keys, Y, 512, *lgss_model()[0], td.lgss_aux_fn,
        theta={"a": A, "sigma_x": SX, "sigma_y": SY},
        resample_algorithm="SISR", return_particles=False,
    ).loglike.numpy().astype(np.float64)
    se = np.sqrt(ll_sharded.var() / len(ll_sharded)
                 + ll_plain.var() / len(ll_plain))
    assert abs(ll_sharded.mean() - ll_plain.mean()) < max(4 * se, 0.3)


def test_sharded_rmpf_runs_and_tracks(ranks):
    ll, states = result(ranks, "rmpf")
    assert np.isfinite(ll).all()
    est = states[:, :, 0].mean(axis=0)
    assert np.sqrt(np.mean((est - X_RM[1:]) ** 2)) < 0.5


def test_sharded_obs_times_gaps(ranks):
    lls = result(ranks, "gaps")[0].astype(np.float64)
    assert abs(lls.mean() - GAP_TRUTH) < 0.3


def test_sharded_masked_particle_counts(ranks):
    truth = kalman_loglik(Y, A, C, SX, SY)
    ll = float(result(ranks, "masked")[0][0])
    assert np.isfinite(ll)
    assert abs(ll - truth) < 3.0


# ---- per key against the JAX package -----------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_filter_matches_jax_per_key(ranks, variant):
    """The (1 x 2) layout against JAX's (4 x 2) mesh, chain by chain."""
    kw, y = VARIANTS[variant]
    want = jax_sharded(y, (4, 2), 17, KEY_CHAINS, KEY_PARTICLES, **kw)
    got = result(ranks, f"key_{variant}")
    assert np.isfinite(got[0]).all()
    assert_per_key(got, want, ROUNDING_SHARE.get(variant, SHARE))


def test_chains_mesh_matches_jax_per_key(ranks):
    """A (2 x 1) layout against JAX's (8 x 1) mesh: the particle axis of
    size 1 still folds the shard index (0) into the model streams."""
    want = jax_sharded(Y, (8, 1), 17, KEY_CHAINS, KEY_PARTICLES)
    assert_per_key(result(ranks, "key_chains_mesh"), want)


def test_masked_counts_match_jax_per_key(ranks):
    """``particle_filter_core(particle_axis=...)`` called directly with a
    count below its lane bound, against the JAX core in ``shard_map``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bayesssm_tpu.filters.core import particle_filter_core

    mesh = j_make_chain_mesh(8, particle_axis_size=2)

    def shard_fn():
        res = particle_filter_core(
            jax.random.fold_in(jax.random.key(0), 0), Y, jnp.asarray(384),
            *j_lgss_model()[0], theta={"a": A, "sigma_x": SX, "sigma_y": SY},
            resample_algorithm="SISR", return_particles=False,
            max_particles=512, use_fused=False, particle_axis="particles",
            particle_axis_size=2)
        return res.loglike[None], res.loglike_history[None], res.ess[None]

    fn = shard_map(shard_fn, mesh=mesh, in_specs=(),
                   out_specs=(P(), P(), P()), check_vma=False)
    want = [np.asarray(w) for w in fn()]
    got = result(ranks, "masked")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
