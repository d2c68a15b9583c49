"""The port's whole-sweep filter (BPF, APF, RMPF, gapped days) against
the JAX package, per key.

Each JAX reference is an UN-vmapped ``interpret=True`` call: one chain per
program, whose software stream the port reproduces (a vmapped call uses
the block layout and draws another stream). The port runs all keys of a
case as one batch. Tolerances: LGSS and LGSS-mv 1e-4 in loglike and state
estimates (f32 ulps of the transcendental functions); the sinusoidal
model 1e-3 (XLA's and PyTorch's f32 ``sin`` may differ by an ulp, which
the transition carries on over T days); SIR 1e-3 in loglike (f32
``lgamma(y + 1)`` differs by a few ulps between the libraries, over T
days).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.models.sinusoidal import (
    sinusoidal_sweep_pf_impl as j_sin_pf_impl,
)
from bayesssm_tpu.models.sir import sir_builder_pf_impl as j_sir_pf_impl
from bayesssm_tpu.ops.lgss_sweep_pallas import (
    lgss_bpf_sweep as j_lgss,
    lgss_mv_bpf_sweep as j_lgss_mv,
    lgss_sweep_pf_impl as j_lgss_pf_impl,
)
from bayesssm_tpu.ops.sir_sweep_pallas import sir_filter_sweep as j_sir
from bayesssm_tpu_torch.models.lgss import simulate_lgss, simulate_lgss_mv
from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_sweep_pf_impl,
)
from bayesssm_tpu_torch.models.sir import simulate_sir, sir_sweep_pf_impl
from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.lgss_sweep import (
    _lgss_mv_op,
    lgss_bpf_sweep,
    lgss_mv_bpf_sweep,
    lgss_sweep_pf_impl,
)
from bayesssm_tpu_torch.ops.sir_sweep import sir_bpf_sweep, sir_filter_sweep
from bayesssm_tpu_torch.ops.sweep_builder import (
    build_sweep_op,
    build_sweep_pf_impl,
)
from bayesssm_tpu_torch.utils.kalman import kalman_loglik, kalman_loglik_mv

torch.set_num_threads(1)

A, SX, SY = 0.9, 0.6, 0.4
N_TOTAL, I0, LAM, GAM = 100, 10, 0.4, 0.25
N = 128
KEYS = 4


@pytest.fixture(scope="module")
def lgss_y():
    _, y = simulate_lgss(11, t_val=12, a=A, sigma_x=SX, sigma_y=SY)
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def sir_y():
    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=6)
    return y.astype(np.float32)


def _key_words(first, count=KEYS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + count)])


def _torch_words(kd):
    return torch.as_tensor(kd.astype(np.int64))


def _jax_per_key(fn, kd):
    f = jax.jit(lambda w: fn(jax.random.wrap_key_data(w)))
    outs = [f(jnp.asarray(w)) for w in kd]
    return (np.array([float(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


@pytest.mark.parametrize("algo,method,alive", [
    ("SIS", "stratified", 128), ("SIS", "systematic", 128),
    ("SISR", "stratified", 128), ("SISR", "systematic", 128),
    ("SISAR", "stratified", 128), ("SISAR", "systematic", 128),
    ("SISAR", "stratified", 100),
])
def test_lgss_matches_jax_per_key(lgss_y, algo, method, alive):
    kd = _key_words(10)
    jll, jest = _jax_per_key(
        lambda k: j_lgss(k, jnp.asarray(lgss_y), float(alive), A, SX, SY,
                         max_particles=N, resample_fn=method,
                         resample_algorithm=algo, interpret=True), kd)
    ll, est = lgss_bpf_sweep(_torch_words(kd), lgss_y, float(alive), A, SX,
                             SY, max_particles=N, resample_fn=method,
                             resample_algorithm=algo)
    assert ll.shape == (KEYS,) and est.shape == (KEYS, len(lgss_y) + 1)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-4)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-4)


@pytest.mark.parametrize("alive", [128, 100])
def test_sir_matches_jax_per_key(sir_y, alive):
    kd = _key_words(20)
    jll, jest = _jax_per_key(
        lambda k: j_sir(k, jnp.asarray(sir_y), float(alive), LAM, GAM,
                        N_TOTAL, I0, max_particles=N, interpret=True), kd)
    ll, est = sir_bpf_sweep(_torch_words(kd), sir_y, float(alive), LAM, GAM,
                            N_TOTAL, I0, max_particles=N)
    assert est.shape == (KEYS, len(sir_y) + 1, 2)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-3)


def test_sir_bench_data_matches_jax_per_key():
    _, y = simulate_sir(seed=1405)
    ys = y.astype(np.float32)
    kd = _key_words(0, 2)
    jll, _ = _jax_per_key(
        lambda k: j_sir(k, jnp.asarray(ys), 128.0, 0.5, 0.2, 500, 70,
                        interpret=True), kd)
    ll, _ = sir_bpf_sweep(_torch_words(kd), ys, 128, 0.5, 0.2, 500, 70)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)


def test_batched_twin_equals_chains_one_at_a_time(sir_y):
    """Per-chain counters: a batch of 8 chains with different parameters
    gives each chain exactly its solo result."""
    kd = _key_words(30, 8)
    words = _torch_words(kd)
    lam = torch.linspace(0.2, 0.9, 8)
    gam = torch.linspace(0.1, 0.4, 8)
    ll, est = sir_bpf_sweep(words, sir_y, N, lam, gam, N_TOTAL, I0)
    for c in range(8):
        l1, e1 = sir_bpf_sweep(words[c:c + 1], sir_y, N, lam[c], gam[c],
                               N_TOTAL, I0)
        assert torch.equal(l1[0], ll[c]) and torch.equal(e1[0], est[c])


def test_degenerate_observation_gives_neg_inf(sir_y):
    y_bad = sir_y.copy()
    y_bad[2] = 1.0e7
    ll, est = sir_bpf_sweep(_torch_words(_key_words(0)), y_bad, N, LAM, GAM,
                            N_TOTAL, I0)
    assert torch.isinf(ll).all() and (ll < 0).all()
    assert np.allclose(est.numpy()[:, 3:], 0.0)


def test_sisr_mean_matches_kalman(lgss_y):
    c = 256
    rng = np.random.default_rng(0)
    words = torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64))
    ll, _ = lgss_bpf_sweep(words, lgss_y, N, A, SX, SY,
                           resample_algorithm="SISR")
    lls = ll.double().numpy()
    assert np.isfinite(lls).all()
    truth = kalman_loglik(lgss_y, A, 1.0, SX, SY, p0=1.0)
    se = lls.std() / np.sqrt(c)
    assert abs(lls.mean() - truth) < max(5 * se, 0.1), (lls.mean(), truth)


def test_deterministic_and_cpu_only(sir_y):
    before = dict(_build.launches)
    words = _torch_words(_key_words(5))
    a = sir_bpf_sweep(words, sir_y, N, LAM, GAM, N_TOTAL, I0)
    b = sir_bpf_sweep(words, sir_y, N, LAM, GAM, N_TOTAL, I0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _build.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _build.launch_sweep(None, words, None, torch.zeros(4, 2), None,
                            None, N, d=2, mode=0, systematic=False)


def test_validation_errors(sir_y, lgss_y):
    w = _torch_words(_key_words(0, 1))
    with pytest.raises(ValueError, match="SIS, SISR or SISAR"):
        sir_bpf_sweep(w, sir_y, N, LAM, GAM, N_TOTAL, I0,
                      resample_algorithm="bogus")
    for bad in (100, 384, 2048):
        with pytest.raises(ValueError, match="power of two"):
            sir_bpf_sweep(w, sir_y, bad, LAM, GAM, N_TOTAL, I0)
        with pytest.raises(ValueError, match="power of two"):
            lgss_bpf_sweep(w, lgss_y, bad, A, SX, SY)
    with pytest.raises(ValueError, match="resample_fn"):
        sir_bpf_sweep(w, sir_y, N, LAM, GAM, N_TOTAL, I0,
                      resample_fn="bogus")
    with pytest.raises(ValueError, match="per-day"):
        sir_bpf_sweep(w, sir_y, N, LAM, GAM, N_TOTAL, I0,
                      resample_fn="multinomial")
    with pytest.raises(ValueError, match="algorithm"):
        sir_filter_sweep(w, sir_y, N, LAM, GAM, N_TOTAL, I0, algorithm="X")
    # APF and RMPF sweeps run now.
    for algo in ("APF", "RMPF"):
        ll, _ = sir_filter_sweep(w, sir_y, N, LAM, GAM, N_TOTAL, I0,
                                 algorithm=algo)
        assert torch.isfinite(ll).all()
    with pytest.raises(ValueError, match="sorted positions"):
        lgss_bpf_sweep(w, lgss_y, N, A, SX, SY, resample_fn="multinomial")
    with pytest.raises(ValueError, match="SIS, SISR or SISAR"):
        lgss_bpf_sweep(w, lgss_y, N, A, SX, SY, resample_algorithm="bogus")
    with pytest.raises(ValueError, match="seed_words"):
        lgss_bpf_sweep(torch.zeros(1, 3, dtype=torch.int64), lgss_y, N, A,
                       SX, SY)


def test_builder_argument_checks():
    def f(*a):
        return a

    with pytest.raises(ValueError, match="sorted positions"):
        build_sweep_op(1, f, f, f, 1, resample_fn="multinomial")
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_sweep_op(1, f, f, f, 1, always_resample=True,
                       never_resample=True)
    with pytest.raises(ValueError, match=">= 1"):
        build_sweep_op(1, f, f, f, 1, obs_gaps=(1, 0))
    gapped = build_sweep_op(1, f, f, f, 1, obs_gaps=(1, 2))
    assert gapped.gaps == (1, 2) and gapped.times == (1, 3)
    # The kernel's int32 gaps and times are made once per device.
    table = gapped._gap_table(torch.device("cpu"))
    assert table.dtype == torch.int32 and table.tolist() == [[1, 2], [1, 3]]
    assert gapped._gap_table(torch.device("cpu")) is table
    with pytest.raises(ValueError, match="obs_gaps has 2 entries"):
        gapped(torch.zeros(1, 2, dtype=torch.int64), np.zeros(5), [[0.1]],
               128)
    # A contiguous grid needs no gap loop.
    assert build_sweep_op(1, f, f, f, 1, obs_gaps=(1, 1)).gaps is None
    assert build_sweep_op(1, f, f, f, 1, aux_log_weight_fn=f).algorithm == (
        "APF")
    with pytest.raises(ValueError, match="give one of them"):
        build_sweep_op(1, f, f, f, 1, aux_log_weight_fn=f, move_fn=f)
    with pytest.raises(ValueError, match=r"\[T, 2\]"):
        op = build_sweep_op(1, f, f, f, 1, num_obs_cols=2)
        op(torch.zeros(1, 2, dtype=torch.int64), np.zeros(5), [[0.1]], 128)


def test_pf_impl_factory(sir_y):
    factory = sir_sweep_pf_impl(N_TOTAL, I0)
    kw = dict(y=sir_y, num_particles=N, param_names=["lam", "gamma"],
              model_fns=None, obs_times=None, algorithm="BPF",
              resample_algorithm="SISAR", resample_fn="stratified",
              carry_weights=False)
    pf = factory(**kw)
    words = _torch_words(_key_words(40, 3))
    theta = torch.tensor([[0.4, 0.25], [0.5, 0.2], [0.3, 0.3]])
    ll, est = pf(words, theta)
    # The caller's parameter order is permuted into the sweep's.
    pf_swapped = factory(**{**kw, "param_names": ["gamma", "lam"]})
    ll2, _ = pf_swapped(words, theta[:, [1, 0]])
    assert torch.equal(ll, ll2)
    want, _ = sir_bpf_sweep(words, sir_y, N, theta[:, 0], theta[:, 1],
                            N_TOTAL, I0)
    assert torch.equal(ll, want) and est.shape == (3, len(sir_y) + 1, 2)
    with pytest.raises(ValueError, match="BPF, APF or RMPF"):
        factory(**{**kw, "algorithm": "SIS"})
    for algo in ("APF", "RMPF"):
        ll_a, _ = factory(**{**kw, "algorithm": algo})(words, theta)
        want_a, _ = sir_filter_sweep(words, sir_y, N, theta[:, 0],
                                     theta[:, 1], N_TOTAL, I0,
                                     algorithm=algo)
        assert torch.equal(ll_a, want_a)
    # RMPF forces SISR, also over a requested SIS.
    ll_s, _ = factory(**{**kw, "algorithm": "RMPF",
                         "resample_algorithm": "SIS"})(words, theta)
    assert torch.equal(ll_s, factory(**{**kw, "algorithm": "RMPF"})(
        words, theta)[0])
    with pytest.raises(ValueError, match="one entry per observation"):
        factory(**{**kw, "obs_times": [1, 3]})
    from bayesssm_tpu_torch.ops.sir_sweep import sir_sweep_parts
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_pf_impl

    parts = sir_sweep_parts(N_TOTAL, I0)
    bpf_only = build_sweep_pf_impl(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        ("lam", "gamma"), num_obs_cols=2,
        obs_transform=parts["obs_transform"])
    with pytest.raises(ValueError, match="aux_log_weight_fn"):
        bpf_only(**{**kw, "algorithm": "APF"})
    with pytest.raises(ValueError, match="move_fn"):
        bpf_only(**{**kw, "algorithm": "RMPF"})
    with pytest.raises(ValueError, match="fresh-weight"):
        factory(**{**kw, "carry_weights": True})
    for names in (["a", "b"], ["lam", "lam"], ["lam", "gamma", "gamma"]):
        with pytest.raises(ValueError, match="lam"):
            factory(**{**kw, "param_names": names})


@pytest.mark.parametrize("algo,method,alive", [
    ("APF", "stratified", 128), ("APF", "systematic", 100),
    ("RMPF", "stratified", 128), ("RMPF", "systematic", 100),
])
def test_sir_apf_rmpf_match_jax_per_key(sir_y, algo, method, alive):
    """K1's APF day (aux selection, recomputed ancestor weight, Q2 second
    transition) and RMPF day (forced SISR, then the move), plain sweep
    against JAX ``sir_filter_sweep(..., interpret=True)``, to 1e-3."""
    kd = _key_words(50)
    jll, jest = _jax_per_key(
        lambda k: j_sir(k, jnp.asarray(sir_y), float(alive), LAM, GAM,
                        N_TOTAL, I0, algorithm=algo, max_particles=N,
                        resample_fn=method, interpret=True), kd)
    ll, est = sir_filter_sweep(_torch_words(kd), sir_y, float(alive), LAM,
                               GAM, N_TOTAL, I0, algorithm=algo,
                               max_particles=N, resample_fn=method)
    assert torch.isfinite(ll).all()
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-3)


@pytest.mark.parametrize("algo", ["BPF", "APF", "RMPF"])
def test_sir_obs_times_match_jax_per_key(sir_y, algo):
    """``obs_times`` as K1's gap loop: the transition runs ``gaps[t]``
    times a day at ``times[t] - gaps[t] + s`` (the APF's second transition
    at ``times[t] - 1``), through the ``pf_impl`` factories of both
    packages, to 1e-3."""
    obs_times = [1, 3, 4, 6, 8, 9]
    args = (sir_y, N, ["lam", "gamma"], None, obs_times, algo, "SISAR",
            "stratified", False)
    j_pf = j_sir_pf_impl(N_TOTAL, I0, interpret=True)(*args,
                                                     max_particles=N)
    kd = _key_words(60, 2)
    theta = np.array([LAM, GAM], np.float32)
    jll, jest = _jax_per_key(lambda k: j_pf(k, jnp.asarray(theta)), kd)
    pf = sir_sweep_pf_impl(N_TOTAL, I0)(*args, max_particles=N)
    ll, est = pf(_torch_words(kd), torch.as_tensor(theta).expand(2, 2))
    assert torch.isfinite(ll).all()
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-3)


SIN_THETA = np.array([0.8, 1.0, 0.5], np.float32)
SIN_ARGS = (["phi", "sigma_x", "sigma_y"], None, None, "BPF")


@pytest.fixture(scope="module")
def sin_y():
    _, y = simulate_sinusoidal(1405, 12)
    return y.astype(np.float32)


@pytest.mark.parametrize("method,alive", [
    ("stratified", 128), ("systematic", 128), ("stratified", 100),
    ("systematic", 77),
])
def test_sinusoidal_matches_jax_per_key(sin_y, method, alive):
    """The README model's plain sweep (K1c's twin) against un-vmapped JAX
    ``sinusoidal_sweep_pf_impl(interpret=True)``, full and masked lanes."""
    args = (sin_y, alive, *SIN_ARGS, "SISAR", method, False)
    j_pf = j_sin_pf_impl(interpret=True)(*args, max_particles=N)
    kd = _key_words(70, 3)
    jll, jest = _jax_per_key(lambda k: j_pf(k, jnp.asarray(SIN_THETA)), kd)
    pf = sinusoidal_sweep_pf_impl()(*args, max_particles=N)
    ll, est = pf(_torch_words(kd), torch.as_tensor(SIN_THETA).expand(3, 3))
    assert ll.shape == (3,) and est.shape == (3, len(sin_y) + 1)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-3)


def test_sinusoidal_factory_follows_param_names(sin_y):
    """Three parameters in any order reach the functor as (phi, sigma_x,
    sigma_y); the factory keeps build_sweep_pf_impl's checks."""
    words = _torch_words(_key_words(80, 3))
    theta = torch.tensor([[0.8, 1.0, 0.5], [0.6, 0.7, 0.9], [0.9, 1.3, 0.3]])
    kw = dict(y=sin_y, num_particles=N, model_fns=None, obs_times=None,
              algorithm="BPF", resample_algorithm="SISAR",
              resample_fn="stratified", carry_weights=False)
    factory = sinusoidal_sweep_pf_impl()
    ll, _ = factory(param_names=["phi", "sigma_x", "sigma_y"], **kw)(
        words, theta)
    perm = ["sigma_y", "phi", "sigma_x"]
    ll2, _ = factory(param_names=perm, **kw)(words, theta[:, [2, 0, 1]])
    assert torch.equal(ll, ll2) and torch.isfinite(ll).all()
    with pytest.raises(ValueError, match="aux_log_weight_fn"):
        factory(param_names=perm, **{**kw, "algorithm": "APF"})
    with pytest.raises(ValueError, match="sweep built for parameters"):
        factory(param_names=["phi", "phi", "sigma_y"], **kw)


@pytest.fixture(scope="module")
def mv_y():
    _, y = simulate_lgss_mv(5, t_val=10, a=A, sigma_x=SX, sigma_y=SY)
    return y.astype(np.float32)


MV_OBS_TIMES = [1, 3, 4, 5, 8, 9, 10, 12, 13, 14]


@pytest.mark.parametrize("algo,obs_times,alive", [
    ("SISAR", None, 128), ("SISR", None, 100), ("SISAR", MV_OBS_TIMES, 128),
    ("SISR", MV_OBS_TIMES, 90),
])
def test_lgss_mv_matches_jax_per_key(mv_y, algo, obs_times, alive):
    """K1b-mv's twin (two observation columns, four parameters, the gap
    loop) against un-vmapped JAX ``lgss_mv_bpf_sweep(interpret=True)``."""
    kd = _key_words(90, 3)
    jll, jest = _jax_per_key(
        lambda k: j_lgss_mv(k, jnp.asarray(mv_y), float(alive), A, SX,
                            (SY, 0.5), obs_times=obs_times, max_particles=N,
                            resample_algorithm=algo, interpret=True), kd)
    ll, est = lgss_mv_bpf_sweep(_torch_words(kd), mv_y, float(alive), A, SX,
                                (SY, 0.5), obs_times=obs_times,
                                max_particles=N, resample_algorithm=algo)
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-4)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-4)


def _predictive_loglik_mv(y, a, c_vec, sigma_x, sigma_y_vec, p0=1.0):
    """Sum over days of log N(y_t; 0, c c' P_t + R) with the prior
    variance P_t of x_t: the Kalman recursion without its update step,
    which is what fresh-weight SIS estimates (its particles are never
    resampled, so each day's weights see the prior marginal of x_t)."""
    cv = np.asarray(c_vec, np.float64)
    r = np.diag(np.asarray(sigma_y_vec, np.float64) ** 2)
    p, ll = p0 ** 2, 0.0
    for obs in np.asarray(y, np.float64):
        p = a * a * p + sigma_x ** 2
        s = np.outer(cv, cv) * p + r
        _, logdet = np.linalg.slogdet(2.0 * np.pi * s)
        ll += -0.5 * (logdet + obs @ np.linalg.solve(s, obs))
    return ll


def test_lgss_mv_sis_mean_matches_its_exact_value(mv_y):
    """SIS, which the JAX vector sweep refuses: the mean over 256 chains
    within max(5 SE, 0.1) of its exact value. Fresh-weight SIS (the
    reference's) never resamples and never carries weights, so it
    estimates the product of the prior predictive densities, not the
    filter's likelihood: the Kalman predict-only recursion, not
    ``kalman_loglik_mv`` (4 nats above it on these data)."""
    c = 256
    rng = np.random.default_rng(1)
    words = torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64))
    ll, _ = lgss_mv_bpf_sweep(words, mv_y, N, A, SX, (SY, 0.5),
                              resample_algorithm="SIS")
    lls = ll.double().numpy()
    assert np.isfinite(lls).all()
    truth = _predictive_loglik_mv(mv_y, A, (1.0, 0.5), SX, (SY, 0.5))
    se = lls.std() / np.sqrt(c)
    assert abs(lls.mean() - truth) < max(5 * se, 0.1), (lls.mean(), truth)
    assert kalman_loglik_mv(mv_y, A, (1.0, 0.5), SX, (SY, 0.5)) > truth + 1
    with pytest.raises(ValueError, match="SIS, SISR or SISAR"):
        lgss_mv_bpf_sweep(words, mv_y, N, A, SX, (SY, 0.5),
                          resample_algorithm="bogus")


def test_lgss_mv_sisr_mean_matches_kalman(mv_y):
    """SISR, the filter's likelihood: within max(5 SE, 0.1) of
    ``kalman_loglik_mv``."""
    c = 128
    rng = np.random.default_rng(2)
    words = torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64))
    ll, _ = lgss_mv_bpf_sweep(words, mv_y, 512, A, SX, (SY, 0.5),
                              resample_algorithm="SISR")
    lls = ll.double().numpy()
    truth = kalman_loglik_mv(mv_y, A, (1.0, 0.5), SX, (SY, 0.5))
    se = lls.std() / np.sqrt(c)
    assert abs(lls.mean() - truth) < max(5 * se, 0.1), (lls.mean(), truth)


def test_lgss_mv_four_parameters_follow_param_names(mv_y):
    """A ``pf_impl`` over the LGSS-mv callbacks: four parameters in any
    order reach the functor as (a, sigma_x, sigma_y1, sigma_y2)."""
    op = _lgss_mv_op(1.0, 0.5, 1.0, "stratified", False, False, None)
    names = ("a", "sigma_x", "sigma_y1", "sigma_y2")
    factory = build_sweep_pf_impl(1, op.init_fn, op.transition_fn,
                                  op.log_weight_fn, names, num_obs_cols=2,
                                  kernel=op.kernel)
    args = (mv_y, N)
    tail = (None, None, "BPF", "SISAR", "stratified", False)
    words = _torch_words(_key_words(95, 3))
    theta = torch.tensor([[0.9, 0.6, 0.4, 0.5], [0.5, 0.3, 0.7, 0.2],
                          [0.7, 0.9, 0.3, 0.8]])
    ll, _ = factory(*args, list(names), *tail)(words, theta)
    perm = [3, 1, 0, 2]
    ll2, _ = factory(*args, [names[j] for j in perm], *tail)(
        words, theta[:, perm])
    want, _ = lgss_mv_bpf_sweep(words, mv_y, N, theta[:, 0], theta[:, 1],
                                (theta[:, 2], theta[:, 3]))
    assert torch.equal(ll, ll2) and torch.equal(ll, want)


LGSS_PF_ERRORS = {
    "apf": (dict(algorithm="APF"), "BPF only"),
    "obs_times": (dict(obs_times=[1, 2, 3]), "contiguous"),
    "carry": (dict(carry_weights=True), "fresh-weight"),
    "names": (dict(param_names=["a", "sigma_x", "b"]), "expects parameters"),
}


@pytest.mark.parametrize("case", sorted(LGSS_PF_ERRORS))
def test_lgss_sweep_pf_impl_messages_match_jax(lgss_y, case):
    kw = dict(y=lgss_y, num_particles=N, param_names=["a", "sigma_x",
                                                      "sigma_y"],
              model_fns=None, obs_times=None, algorithm="BPF",
              resample_algorithm="SISAR", resample_fn="stratified",
              carry_weights=False)
    extra, match = LGSS_PF_ERRORS[case]
    kw.update(extra)
    with pytest.raises(ValueError, match=match) as got:
        lgss_sweep_pf_impl()(**kw)
    with pytest.raises(ValueError) as want:
        j_lgss_pf_impl(interpret=True)(**kw)
    assert str(got.value) == str(want.value)


def test_lgss_sweep_pf_impl_runs_the_scalar_sweep(lgss_y):
    """``lgss_sweep_pf_impl`` in any parameter order runs
    ``lgss_bpf_sweep`` on the caller's theta columns; the JAX factory
    agrees per key."""
    kd = _key_words(97, 2)
    words = _torch_words(kd)
    theta = torch.tensor([[A, SX, SY], [0.5, 0.9, 0.3]])
    args = (lgss_y, N, ["sigma_y", "a", "sigma_x"], None, None, "BPF",
            "SISR", "systematic", False)
    ll, est = lgss_sweep_pf_impl()(*args)(words, theta[:, [2, 0, 1]])
    want, _ = lgss_bpf_sweep(words, lgss_y, N, theta[:, 0], theta[:, 1],
                             theta[:, 2], resample_fn="systematic",
                             resample_algorithm="SISR")
    assert torch.equal(ll, want) and est.shape == (2, len(lgss_y) + 1)
    j_pf = j_lgss_pf_impl(interpret=True)(*args)
    jll, _ = _jax_per_key(lambda k: j_pf(k, jnp.asarray(
        np.array([SY, A, SX], np.float32))), kd[:1])
    np.testing.assert_allclose(ll.numpy()[:1], jll, rtol=0, atol=1e-4)
