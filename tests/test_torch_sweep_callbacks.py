"""User-written sweep callbacks in the port: the mirror of
``tests/test_sweep_builder.py`` on the stochastic-volatility callbacks of
``examples/torch_custom_sweep_kernel.py`` (a model with no hand-written
functor), and the plain sweep per key against the JAX builder.

The distributional tests hold the plain sweep to the port's engine as the
JAX tests hold the JAX builder to the JAX engine. The per-key tests hold
it to an UN-vmapped ``interpret=True`` JAX ``build_sweep_op`` with the
JAX example's ``jnp`` callbacks (one chain per program: the stream the
port reproduces), to 1e-4 in loglike and state estimates (f32 ulps of
``exp``/``log``/``sqrt`` over T days). On the card the same callbacks run
as a generated functor (``tests/test_torch_cuda.py``); here, with no card,
the plain sweep runs them.
"""

import importlib.util
import inspect
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.sir_sweep_pallas import (
    sir_sweep_parts as j_sir_sweep_parts,
)
from bayesssm_tpu.ops.sweep_builder import (
    build_sweep_op as j_build_sweep_op,
    build_sweep_pf_impl as j_build_sweep_pf_impl,
)
from bayesssm_tpu.pmmh.tuning import (
    default_tune_control as j_default_tune_control,
    run_pilot_chain as j_run_pilot_chain,
)
from bayesssm_tpu_torch.filters import (
    auxiliary_filter,
    bootstrap_filter,
    resample_move_filter,
)
from bayesssm_tpu_torch.models.sir import simulate_sir
from bayesssm_tpu_torch.models.stochastic_volatility import simulate_sv, sv_model
from bayesssm_tpu_torch.ops import _build, threefry
from bayesssm_tpu_torch.ops.sir_sweep import sir_sweep_parts
from bayesssm_tpu_torch.ops.sweep_builder import (
    build_sweep_op,
    build_sweep_pf_impl,
)
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh
from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
from bayesssm_tpu_torch.pmmh.tuning import run_pilot_chain

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHI, SIG, MU = 0.9, 0.4, -0.8
THETA = [PHI, SIG, MU]
N = 128
PARAMS = ("phi", "sigma", "mu")
KEYS = 3


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _load("torch_custom_sweep_kernel")      # the port's SV callbacks
JEX = _load("custom_sweep_kernel")           # the JAX example's
SV = (1, EX.sv_init, EX.sv_transition, EX.sv_log_weight, 3)
JSV = (1, JEX.sv_init, JEX.sv_transition, JEX.sv_log_weight, 3)


def sv_move(rng, cols, th, y_t):
    """The RMPF move of ``tests/test_sweep_builder.py:43-48``, in torch."""
    x = cols[0]
    prop = x + 0.3 * rng.normal()
    log_ratio = (EX.sv_log_weight((prop,), th, y_t)
                 - EX.sv_log_weight((x,), th, y_t))
    accept = torch.log(rng.uniform()) < log_ratio
    return (torch.where(accept, prop, x),)


def j_sv_move(rng, cols, th, y_t):
    x = cols[0]
    prop = x + 0.3 * rng.normal()
    log_ratio = (JEX.sv_log_weight((prop,), th, y_t)
                 - JEX.sv_log_weight((x,), th, y_t))
    accept = jnp.log(rng.uniform()) < log_ratio
    return (jnp.where(accept, prop, x),)


@pytest.fixture(scope="module")
def ys():
    _, y = simulate_sv(3, 10, phi=PHI, sigma=SIG, mu=MU)
    return y.astype(np.float32)


def _words(c, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64))


def _sweep_batch(ys, c, seed, num_particles=N, max_particles=N, **kw):
    op = build_sweep_op(*SV, **kw)
    theta = torch.tensor([THETA]).expand(c, 3)
    return op(_words(c, seed), ys, theta, float(num_particles),
              max_particles=max_particles)


def _sv_engine_move(key, particles, y):
    """The engine's twin of ``sv_move`` (threefry draws)."""
    loglik = sv_model()[0][2]
    k1, k2 = threefry.split(key).unbind(-2)
    n = particles.shape[-1]
    prop = particles + 0.3 * threefry.normal(k1, (n,))
    log_ratio = loglik(y, prop) - loglik(y, particles)
    accept = torch.log(threefry.uniform(k2, (n,))) < log_ratio
    return torch.where(accept, prop, particles)


def _engine_batch(ys, c, seed, algorithm="BPF", num_particles=N):
    fns = sv_model()[0]
    theta = dict(phi=PHI, sigma=SIG, mu=MU)
    keys = threefry.fold_in(threefry.key(seed), torch.arange(c))
    if algorithm == "APF":
        r = auxiliary_filter(keys, ys, num_particles, *fns, fns[2],
                             theta=theta, return_particles=False)
    elif algorithm == "RMPF":
        r = resample_move_filter(keys, ys, num_particles, *fns,
                                 _sv_engine_move, theta=theta,
                                 return_particles=False)
    else:
        r = bootstrap_filter(keys, ys, num_particles, *fns, theta=theta,
                             return_particles=False)
    return r.loglike, r.state_est


def _match(ll_s, es_s, ll_c, es_c, c):
    """``tests/test_sweep_builder.py::_match``: means within 4 SE, state
    estimates within 0.3."""
    assert torch.isfinite(ll_s).all()
    se_tol = 4.0 * float(np.hypot(float(ll_s.double().std()),
                                  float(ll_c.double().std()))) / np.sqrt(c)
    assert abs(float(ll_s.double().mean() - ll_c.double().mean())) < se_tol
    np.testing.assert_allclose(es_s.mean(0).numpy(), es_c.mean(0).numpy(),
                               atol=0.3)


@pytest.mark.parametrize("algorithm", ["BPF", "APF", "RMPF"])
def test_filters_match_the_engine(ys, algorithm):
    """BPF, APF (the aux callback) and RMPF (the move callback) days of
    the plain sweep against the port's engine, in distribution."""
    c = 160
    kw = {"APF": dict(aux_log_weight_fn=EX.sv_log_weight),
          "RMPF": dict(move_fn=sv_move, always_resample=True)}.get(
              algorithm, {})
    ll_s, es_s = _sweep_batch(ys, c, 2, **kw)
    ll_c, es_c = _engine_batch(ys, c, 3, algorithm)
    _match(ll_s, es_s, ll_c, es_c, c)


def test_masked_lanes(ys):
    c = 128
    ll_m, _ = _sweep_batch(ys, c, 8, num_particles=64)
    ll_c, _ = _engine_batch(ys, c, 9, num_particles=64)
    assert torch.isfinite(ll_m).all()
    se_tol = 4.0 * float(np.hypot(float(ll_m.double().std()),
                                  float(ll_c.double().std()))) / np.sqrt(c)
    assert abs(float(ll_m.double().mean() - ll_c.double().mean())) < se_tol


def test_deterministic_per_key(ys):
    """Each chain's result depends on its own words only: a batch equals
    its chains one at a time, and a second call equals the first."""
    ll1, es1 = _sweep_batch(ys, 8, 10)
    ll2, es2 = _sweep_batch(ys, 8, 10)
    assert torch.equal(ll1, ll2) and torch.equal(es1, es2)
    op = build_sweep_op(*SV)
    words = _words(8, 10)
    theta = torch.tensor([THETA])
    for c in (0, 5):
        ll, es = op(words[c:c + 1], ys, theta, float(N))
        assert torch.equal(ll[0], ll1[c]) and torch.equal(es[0], es1[c])


def test_validation(ys):
    with pytest.raises(ValueError, match="sorted positions"):
        build_sweep_op(*SV, resample_fn="multinomial")
    op = build_sweep_op(*SV)
    for bad in (100, 384):
        with pytest.raises(ValueError, match="power of two"):
            op(_words(1, 0), ys, torch.zeros((1, 3)), bad)
    for builder in (build_sweep_op, j_build_sweep_op):
        with pytest.raises(ValueError, match="given together"):
            builder(*SV, pack_fn=lambda cols: cols)
    with pytest.raises(ValueError, match="given together"):
        build_sweep_pf_impl(1, *SV[1:4], PARAMS, unpack_fn=lambda p: p)


@pytest.mark.parametrize("port,jax_fn", [
    (build_sweep_op, j_build_sweep_op),
    (build_sweep_pf_impl, j_build_sweep_pf_impl),
])
def test_builders_take_every_jax_argument(port, jax_fn):
    """A call written for the JAX builder runs on the port's: every JAX
    parameter exists, in the same order, with the same default."""
    ours = inspect.signature(port).parameters
    theirs = inspect.signature(jax_fn).parameters
    names = [q for q in ours if q in theirs]
    assert names == list(theirs)
    for q in theirs:
        assert ours[q].default == theirs[q].default, q
    # JAX's keywords reach the plain sweep: interpret is ignored there.
    op = port(*SV[:4], 3 if port is build_sweep_op else PARAMS,
              interpret=True, num_obs_cols=1, num_packed_cols=1)
    assert callable(op)


def test_pmmh_pf_impl_hook(ys):
    (init_fn, trans_fn, loglik_fn), log_priors, transform = sv_model()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh(
            "bootstrap_filter", ys, 16, init_fn, trans_fn, loglik_fn,
            log_priors,
            pilot_init_params=[{"phi": 0.9, "sigma": 0.4, "mu": -0.5}] * 2,
            burn_in=4, num_chains=2, param_transform=transform, seed=17,
            tune_control=default_tune_control(pilot_m=16, pilot_burn_in=4,
                                              pilot_reps=3),
            print_summary=False, pf_impl=build_sweep_pf_impl(
                *SV[:4], PARAMS, interpret=True),
            device="cpu")
    for pname, chain in out.theta_chain.items():
        assert chain.shape == (2, 12), (pname, chain.shape)
        assert np.isfinite(chain).all(), pname


def test_pf_impl_validation(ys):
    pf_impl = build_sweep_pf_impl(*SV[:4], PARAMS, interpret=True)
    kw = dict(y=ys, num_particles=N, param_names=list(PARAMS),
              model_fns=None, obs_times=None, algorithm="BPF",
              resample_algorithm="SISAR", resample_fn="stratified",
              carry_weights=False)
    pf_impl(**kw)
    with pytest.raises(ValueError, match="aux_log_weight_fn"):
        pf_impl(**{**kw, "algorithm": "APF"})
    with pytest.raises(ValueError, match="built for parameters"):
        pf_impl(**{**kw, "param_names": ["x", "y", "z"]})
    with pytest.raises(ValueError, match="one entry per observation"):
        pf_impl(**{**kw, "obs_times": [1, 3]})
    with pytest.raises(ValueError, match="strictly increasing"):
        pf_impl(**{**kw, "obs_times": list(range(len(ys), 0, -1))})


def test_gap_times_are_absolute_transition_indices():
    """The gapped day loop calls transition_fn with the absolute 0-based
    transition index (times[t] - gap + s); a deterministic transition
    x += t makes the state estimate show which times were used."""

    def init(rng, th):
        return (torch.zeros_like(th[0]),)

    def trans(rng, cols, th, t):
        return (cols[0] + t,)

    def lw(cols, th, y_t):
        return torch.zeros_like(cols[0])  # flat weights: no resampling

    op = build_sweep_op(1, init, trans, lw, 1, obs_gaps=(2, 3))
    _, est = op(_words(1, 0), np.zeros(2, np.float32), torch.zeros((1, 1)),
                128)
    np.testing.assert_allclose(est[0].numpy(), [0.0, 1.0, 10.0], atol=1e-5)
    # The traced transition reads t as an int and adds it as float32.
    traced = op.trace().fns["transition"]
    assert [n.op for n in traced.nodes if n.op != "theta"] == [
        "col", "time", "add"]


def _key_words(first, count=KEYS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + count)])


def _jax_per_key(op, kd, ys, theta, alive):
    f = jax.jit(lambda w: op(jax.random.wrap_key_data(w), jnp.asarray(ys),
                             jnp.asarray(theta, jnp.float32), float(alive),
                             max_particles=N))
    outs = [f(jnp.asarray(w)) for w in kd]
    return (np.array([float(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


PER_KEY = {
    "bpf": (dict(), dict(), 128),
    "bpf_systematic_masked": (dict(resample_fn="systematic"),
                              dict(resample_fn="systematic"), 100),
    "apf": (dict(aux_log_weight_fn=EX.sv_log_weight),
            dict(aux_log_weight_fn=JEX.sv_log_weight), 128),
    "rmpf": (dict(move_fn=sv_move, always_resample=True),
             dict(move_fn=j_sv_move, always_resample=True), 90),
    "gapped": (dict(obs_gaps=(1, 2, 1, 3, 1, 1, 2, 1, 1, 2)),
               dict(obs_gaps=(1, 2, 1, 3, 1, 1, 2, 1, 1, 2)), 128),
    "sis": (dict(never_resample=True), dict(never_resample=True), 128),
}


@pytest.mark.parametrize("case", sorted(PER_KEY))
def test_plain_sweep_matches_jax_per_key(ys, case):
    """The port's plain sweep of the SV callbacks against the JAX builder
    with the JAX example's callbacks, un-vmapped, per key, to 1e-4."""
    kw, jkw, alive = PER_KEY[case]
    kd = _key_words(40)
    jll, jest = _jax_per_key(j_build_sweep_op(*JSV, interpret=True, **jkw),
                             kd, ys, THETA, alive)
    ll, est = build_sweep_op(*SV, **kw)(
        torch.as_tensor(kd.astype(np.int64)), ys,
        torch.tensor([THETA]).expand(KEYS, 3), float(alive), max_particles=N)
    assert torch.isfinite(ll).all()
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-4)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-4)


@pytest.mark.parametrize("algorithm", ["BPF", "APF"])
def test_sir_pack_pair_matches_jax_per_key(algorithm):
    """``pack_fn``/``unpack_fn`` with JAX's semantics: the SIR callbacks
    with the (S, I) pack pair of ``ops/sir_sweep_pallas.py:184-193``,
    written in torch, against the JAX builder with its own pair, per key
    (SIR's 1e-3: f32 ``lgamma(y + 1)`` ulps)."""
    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=6)
    parts = sir_sweep_parts(100, 10)
    jparts = j_sir_sweep_parts(100, 10)
    y2 = parts["obs_transform"](torch.as_tensor(y))
    apf = algorithm == "APF"

    def pack(cols):
        return (cols[0] * 4096.0 + cols[1],)

    def unpack(packed):
        v = packed[0]
        s = torch.floor(v * (1.0 / 4096.0))
        return (s, v - s * 4096.0)

    op = build_sweep_op(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        2, aux_log_weight_fn=parts["aux_log_weight_fn"] if apf else None,
        num_obs_cols=2, pack_fn=pack, unpack_fn=unpack, num_packed_cols=1)
    jop = j_build_sweep_op(
        2, jparts["init_fn"], jparts["transition_fn"],
        jparts["log_weight_fn"], 2,
        aux_log_weight_fn=jparts["aux_log_weight_fn"] if apf else None,
        interpret=True, num_obs_cols=2, **jparts["pack_kw"])
    assert jparts["pack_kw"]["num_packed_cols"] == 1
    kd = _key_words(60, 2)
    theta = [0.4, 0.25]
    jll, jest = _jax_per_key(jop, kd, np.asarray(y2), theta, 100)
    ll, est = op(torch.as_tensor(kd.astype(np.int64)), y2,
                 torch.tensor([theta]).expand(2, 2), 100.0, max_particles=N)
    assert torch.isfinite(ll).all()
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-3)
    np.testing.assert_allclose(est.numpy(), jest, rtol=0, atol=1e-3)
    # An exact pair routes one column and changes no bit of the sweep.
    plain = build_sweep_op(
        2, parts["init_fn"], parts["transition_fn"], parts["log_weight_fn"],
        2, aux_log_weight_fn=parts["aux_log_weight_fn"] if apf else None,
        num_obs_cols=2)
    ll_u, est_u = plain(torch.as_tensor(kd.astype(np.int64)), y2,
                        torch.tensor([theta]).expand(2, 2), 100.0,
                        max_particles=N)
    assert torch.equal(ll, ll_u) and torch.equal(est, est_u)


PILOT = dict(pilot_m=8, pilot_reps=4)
PILOT_THETA0 = np.array([[0.9, 0.4, -0.5], [0.8, 0.3, -1.5]], np.float32)


def test_pmmh_phase_one_matches_the_jax_driver_per_key(ys):
    """``pmmh()``'s phase 1 through the sweep ``pf_impl`` (logit phi):
    each chain's pilot chain, log-likelihoods, mean and covariance against
    an UN-vmapped JAX ``run_pilot_chain`` with the JAX example's callbacks
    on the same key. (Its pilot variance runs vmapped over repetitions, so
    its sweeps draw another stream there; the port's repetitions take the
    un-vmapped stream.)"""
    fns, log_priors, transform = sv_model()
    names = list(log_priors)
    transforms = resolve_transforms(transform, names)
    from bayesssm_tpu.models.stochastic_volatility import (
        sv_model as j_sv_model,
    )

    j_fns, j_priors, _ = j_sv_model()
    j_pf = j_build_sweep_pf_impl(*JSV[:4], PARAMS, interpret=True)
    j_control = j_default_tune_control(**PILOT)
    j_fn = jax.jit(lambda k, th: j_run_pilot_chain(
        k, jnp.asarray(ys), names, (*j_fns, None, None),
        [j_priors[q] for q in names], th, transforms, j_control,
        pf_impl=j_pf))
    root = jax.random.key(11)
    want = [{k: np.asarray(v) for k, v in j_fn(
        jax.random.fold_in(root, c), jnp.asarray(PILOT_THETA0[c])).items()}
        for c in range(len(PILOT_THETA0))]
    keys = threefry.fold_in(threefry.key(11), torch.arange(2))
    got = run_pilot_chain(keys, ys, names, (*fns, None, None),
                          [log_priors[q] for q in names], PILOT_THETA0,
                          transforms, default_tune_control(**PILOT),
                          pf_impl=build_sweep_pf_impl(*SV[:4], PARAMS))
    for c in range(2):
        np.testing.assert_allclose(got["pilot_theta_chain"][c].numpy(),
                                   want[c]["pilot_theta_chain"], atol=1e-5)
        np.testing.assert_allclose(got["pilot_loglike_chain"][c].numpy(),
                                   want[c]["pilot_loglike_chain"], atol=1e-4)
        np.testing.assert_allclose(got["pilot_theta_mean"][c].numpy(),
                                   want[c]["pilot_theta_mean"], atol=1e-5)
        np.testing.assert_allclose(got["pilot_theta_cov"][c].numpy(),
                                   want[c]["pilot_theta_cov"], rtol=1e-4,
                                   atol=1e-7)
    assert float(got["pilot_accept_rate"].max()) > 0.0


def test_example_main_runs_on_the_cpu():
    before = dict(_build.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = EX.main(m=8, device="cpu")
    assert _build.launches == before
    for arr in out.theta_chain.values():
        assert arr.shape == (2, 6) and np.isfinite(arr).all()


# --- a callback's own event loop: the LV Gillespie callbacks ----------------
# benchmark/programs/lvssa.py runs its Poisson start and its exact LV
# intervals through the port's ``rng.event_loop``; the JAX builder's
# callbacks thread the counter through a ``lax.while_loop`` (its
# ``SweepRng`` docstring). The contract is the same: iteration k draws at
# ctr + draws * k while a lane of the chain runs, stopped lanes keep their
# carry, and the counter ends at ctr + draws * (iterations run).
LVSSA_MAX = 100_000
# Rates a tenth of the configuration's: a few dozen events a lane.
LVSSA_THETA = [0.1, 0.0005, 0.06]


def _j_event_loop(rng, running, step, carry, draws):
    from jax import lax

    def cond(c):
        state, k, _ = c
        return jnp.any(running(state)) & (k < LVSSA_MAX)

    def body(c):
        state, k, ctr = c
        live = running(state)
        u, ctr = rng.raw_uniform_blocks(draws, ctr)
        new = step(tuple(u[j] for j in range(draws)), state)
        return (tuple(jnp.where(live, a, b) for a, b in zip(new, state)),
                k + 1, ctr)

    state, _, ctr = lax.while_loop(
        cond, body, (tuple(carry), jnp.int32(0), rng.counter()))
    rng.set_counter(ctr)
    return state


def j_lvssa_init(rng, theta):
    def poisson(mean):
        def arrive(u, c):
            n, s = c
            s = s - jnp.log1p(-u[0])
            return jnp.where(s < mean, n + 1.0, n), s

        zero = jnp.zeros_like(theta[0])
        return _j_event_loop(rng, lambda c: c[1] < mean, arrive,
                             (zero, zero), 1)[0]

    return poisson(50.0), poisson(100.0)


def j_lvssa_transition(rng, cols, theta, t):
    c1, c2, c3 = theta

    def hazards(x1, x2):
        h1 = c1 * x1
        h12 = h1 + c2 * x1 * x2
        return h1, h12, h12 + c3 * x2

    def running(c):
        return (c[2] > 0.0) & (hazards(c[0], c[1])[2] > 0.0)

    def event(u, c):
        x1, x2, r = c
        h1, h12, h0 = hazards(x1, x2)
        r = r + jnp.log1p(-u[0]) / h0
        fire = r > 0.0
        v = u[1] * h0
        birth = fire & (v < h1)
        predation = fire & (v >= h1) & (v < h12)
        death = fire & (v >= h12)
        x1 = jnp.where(birth, x1 + 1.0, jnp.where(predation, x1 - 1.0, x1))
        x2 = jnp.where(predation, x2 + 1.0, jnp.where(death, x2 - 1.0, x2))
        return x1, x2, r

    x1, x2 = cols
    x1, x2, _ = _j_event_loop(rng, running, event,
                              (x1, x2, jnp.full_like(x1, 2.0)), 2)
    return x1, x2


def j_lv_log_weight(cols, theta, y_t):
    z1 = (y_t[0] - cols[0]) / 10.0
    z2 = (y_t[1] - cols[1]) / 10.0
    return (-2.0 * (0.5 * np.log(2.0 * np.pi) + np.log(10.0))
            - 0.5 * (z1 * z1 + z2 * z2))


def test_event_loop_callbacks_match_jax_per_key():
    """The LV Gillespie callbacks through the port's plain sweep against
    the JAX builder with counter-threaded ``lax.while_loop`` callbacks,
    un-vmapped, per key, to 1e-4; one observation, 100 of 128 lanes."""
    from benchmark.programs import lvssa

    params = list(lvssa.PARAMS)
    ys = np.array([[45.0, 95.0]], np.float32)
    args = (ys, 100, params, None, None, "BPF", "SISAR", "stratified",
            False)
    j_pf = j_build_sweep_pf_impl(
        2, j_lvssa_init, j_lvssa_transition, j_lv_log_weight, params,
        interpret=True, num_obs_cols=2)(*args, max_particles=N)
    kd = _key_words(60, 2)
    f = jax.jit(lambda w: j_pf(jax.random.wrap_key_data(w),
                               jnp.asarray(LVSSA_THETA, jnp.float32)))
    outs = [f(jnp.asarray(w)) for w in kd]
    pf = lvssa.lvssa_pf_impl()(*args, max_particles=N)
    ll, est = pf(torch.as_tensor(kd.astype(np.int64)),
                 torch.tensor([LVSSA_THETA]).expand(2, 3), 100)
    assert torch.isfinite(ll).all()
    np.testing.assert_allclose(ll.numpy(), [float(o[0]) for o in outs],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(est.numpy(),
                               np.stack([np.asarray(o[1]) for o in outs]),
                               rtol=0, atol=1e-4)
    # The start and the interval moved the state: events fired.
    assert not np.allclose(est.numpy()[:, 0], est.numpy()[:, 1])
