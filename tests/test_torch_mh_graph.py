"""The MH step as two halves around the filter, replayed as CUDA graphs
where captured (``bayesssm_tpu_torch/pmmh/driver.py``: ``mh_propose``,
``mh_accept``, ``_MHStep``, ``sample_chains``).

On the CPU: the step counter as a device tensor gives the int step's
words; the two halves compose to the step as it was before the split
(``_mh_step_before``, its code kept here); ``sample_chains`` gives the
samples, accept counts and state of the loop it replaced
(``_sample_before``) and replays nothing; and the path the card runs
(the tensors the capture binds, the step counter, the capture after one
direct step, the copies a filter is given, fallback and the cache) runs
with captures that run their function instead of recording it
(``fake_graphs``). On the card (``-m cuda``, skipped here): real
captures, bit for bit with the halves called directly. The file imports
no JAX, so the card runs it with ``--noconftest``.
"""

import collections
import math

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.models.sir import (
    simulate_sir,
    sir_model,
    sir_sweep_pf_impl,
)
from bayesssm_tpu_torch.models.stochastic_volatility import sv_model
from bayesssm_tpu_torch.pmmh import driver
from bayesssm_tpu_torch.pmmh.driver import (
    _uniform,
    chain_words,
    init_chain_state,
    mh_accept,
    mh_propose,
    mh_step,
    sample_chains,
    step_words,
)
from bayesssm_tpu_torch.pmmh.priors import sum_log_priors
from bayesssm_tpu_torch.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    resolve_transforms,
    transform_params,
)
from bayesssm_tpu_torch.ops.rng import box_muller
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

N_TOTAL, I0, N = 100, 10, 128


def _mh_step_before(pf, theta, ll, factor, n_chain, eps, u_acc, seed_words,
                    prior_fns, transforms, jacobian_convention="consistent",
                    se=None):
    """``mh_step`` as it was before its halves were split out."""
    z = transform_params(theta, transforms)
    zp = z + (factor * eps[:, None, :]).sum(dim=-1)
    theta_prop = back_transform_params(zp, transforms)
    lp_prop = sum_log_priors(theta_prop, prior_fns)
    ll_prop, se_prop = pf(seed_words, theta_prop, n_chain)
    log_ratio = (
        ll_prop + lp_prop
        + log_jacobian(theta_prop, transforms, jacobian_convention)
    ) - (
        ll + sum_log_priors(theta, prior_fns)
        + log_jacobian(theta, transforms, jacobian_convention)
    )
    log_ratio = torch.where(
        torch.isnan(log_ratio) | ~torch.isfinite(lp_prop), -math.inf,
        log_ratio,
    )
    accept = torch.log(u_acc) < log_ratio
    theta = torch.where(accept[:, None], theta_prop, theta)
    ll = torch.where(accept, ll_prop, ll)
    if se is not None:
        keep = accept.reshape((-1,) + (1,) * (se.ndim - 1))
        se = torch.where(keep, se_prop, se)
    return theta, ll, se, accept


def _sample_before(pf, state, m, burn_in, prior_fns, transforms,
                   jacobian_convention="consistent"):
    """``sample_chains``' eager loop as it was before the graphs (no
    state estimates): ``(samples, accepted, theta, ll)``."""
    c, p = state.theta.shape
    theta, ll = state.theta, state.ll
    if ll is None:
        ll, _ = pf(step_words(state.words, 0, 2), state.theta, state.n)
    out = [theta]
    accepts = torch.zeros(c, dtype=torch.int64, device=theta.device)
    for s in range(1, m):
        w = step_words(state.words, state.step + s, 3 + 2 * p)
        u = _uniform(w[:, 2:2 + 2 * p])
        eps = box_muller(u[:, 0::2], u[:, 1::2])
        theta, ll, _, accept = _mh_step_before(
            pf, theta, ll, state.factors, state.n, eps,
            _uniform(w[:, 2 + 2 * p]), w[:, :2], prior_fns, transforms,
            jacobian_convention)
        accepts += accept
        out.append(theta)
    samples = torch.stack(out[burn_in:], dim=1)
    return samples.cpu().numpy(), accepts.cpu().numpy(), theta, ll


def _sir():
    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=6)
    _, log_priors, transform = sir_model()
    names = list(log_priors)
    return (y.astype(np.float32), [log_priors[q] for q in names],
            resolve_transforms(transform, names))


@pytest.fixture(scope="module")
def sir():
    y, prior_fns, transforms = _sir()
    pf = sir_sweep_pf_impl(N_TOTAL, I0)(
        y, N, ["lam", "gamma"], None, None, "BPF", "SISAR", "stratified",
        False, max_particles=N)
    return pf, prior_fns, transforms


def _state(c, seed, device="cpu", theta0=(0.4, 0.25)):
    p = len(theta0)
    factors = np.tile(np.diag([0.1] * p).astype(np.float32), (c, 1, 1))
    return init_chain_state(list(theta0), factors, N, seed, device)


def _assert_same(res, before):
    samples, accepted, theta, ll = before
    np.testing.assert_array_equal(res.samples, samples)
    np.testing.assert_array_equal(res.accepted, accepted)
    assert torch.equal(res.state.theta, theta)
    assert torch.equal(res.state.ll, ll)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("step", [0, 1, 2**31 - 1, 2**31, 2**32 + 5])
def test_a_device_step_counter_gives_the_int_steps_words(step):
    words = chain_words(1405, 16, "cpu")
    as_tensor = torch.tensor(step, dtype=torch.int64)
    assert torch.equal(step_words(words, as_tensor, 9),
                       step_words(words, step, 9))


def _models():
    _, sir_priors, sir_tr = sir_model()
    _, sv_priors, sv_tr = sv_model()
    return {
        "sir": (list(sir_priors.values()),
                resolve_transforms(sir_tr, list(sir_priors)),
                [[0.4, 0.25], [0.01, 0.3], [0.5, 0.2], [0.3, 0.01]]),
        # Untransformed rates: a step below 0 leaves the prior's support.
        "sir_identity": (list(sir_priors.values()), ("identity",) * 2,
                         [[0.4, 0.25], [0.01, 0.3], [0.5, 0.2],
                          [0.3, 0.01]]),
        "sv": (list(sv_priors.values()),
               resolve_transforms(sv_tr, list(sv_priors)),
               [[0.97, 0.15, -0.8], [0.5, 0.3, 0.0], [0.99, 0.05, 1.0],
                [0.9, 0.2, -2.0]]),
    }


@pytest.mark.parametrize("convention", ["consistent", "reference"])
@pytest.mark.parametrize("model", ["sir", "sir_identity", "sv"])
def test_the_halves_compose_to_the_step_before_the_split(model, convention):
    prior_fns, transforms, theta = _models()[model]
    theta = torch.tensor(theta, dtype=torch.float32)
    c, p = theta.shape
    gen = torch.Generator().manual_seed(3)
    factor = torch.eye(p).expand(c, p, p) * 0.3
    eps = torch.randn((c, p), generator=gen) * 2.0
    u_acc = torch.tensor([0.01, 0.5, 0.99, 0.3])
    ll = torch.tensor([-20.0, -21.0, -19.5, -20.5])
    # A NaN, a -inf and two finite proposal log-likelihoods.
    ll_prop = torch.tensor([float("nan"), -19.0, -math.inf, -18.0])
    words = chain_words(5, c, "cpu")

    def pf(seed_words, theta_prop, n):
        return ll_prop.clone(), None

    want = _mh_step_before(pf, theta, ll, factor, None, eps, u_acc, words,
                           prior_fns, transforms, convention)
    got = mh_step(pf, theta, ll, factor, None, eps, u_acc, words, prior_fns,
                  transforms, convention)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    theta_prop, lp_prop = mh_propose(theta, factor, eps, prior_fns,
                                     transforms)
    halves = mh_accept(theta, ll, theta_prop, lp_prop, ll_prop, u_acc,
                       prior_fns, transforms, convention)
    for a, b in zip(halves, (want[0], want[1], want[3])):
        assert torch.equal(a, b)
    assert not bool(want[3][0]) and not bool(want[3][2])   # NaN, -inf
    if model == "sir_identity":
        assert not bool(torch.isfinite(lp_prop).all())


@pytest.mark.parametrize("burn_in", [0, 2])
def test_sample_chains_on_the_cpu_is_the_loop_before_and_replays_nothing(
        sir, burn_in):
    pf, prior_fns, transforms = sir
    timing.reset()
    res, counted = _sample(pf, _state(8, 1405), 6, burn_in, prior_fns,
                           transforms)
    _assert_same(res, _sample_before(pf, _state(8, 1405), 6, burn_in,
                                     prior_fns, transforms))
    assert res.state.step == 5
    assert counted == {}
    more = sample_chains(pf, res.state, 4, 0, prior_fns, transforms)
    _assert_same(more, _sample_before(pf, res.state, 4, 0, prior_fns,
                                      transforms))
    timing.reset()


class _FakeGraph:
    """A capture that runs its function, and a replay that runs it again
    on the same arguments and writes its outputs into the first run's, as
    a replay writes into the captured outputs."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args
        self.out = fn(*args)

    def replay(self):
        new = self.fn(*self.args)
        if isinstance(new, torch.Tensor):
            self.out.copy_(new)
        else:
            for old, value in zip(self.out, new):
                old.copy_(value)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The path the card runs, on the CPU, with an empty cache; ``fail``
    makes the captures raise as a capture of host work does."""
    fail = []

    def capture(propose, accept, dev):
        if fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        first = _FakeGraph(propose)
        second = _FakeGraph(accept, first.out)
        return [(first, first.out), (second, second.out)]

    monkeypatch.setattr(driver, "_STEPS", collections.OrderedDict())
    monkeypatch.setattr(driver, "_capture", capture)
    timing.reset()
    yield fail
    timing.reset()


def _sample(*args, **kwargs):
    """``sample_chains``' result and its call's ``mh_graph.*`` counters."""
    res = sample_chains(*args, **kwargs)
    call = timing.recent_calls()[-1]
    assert call["root"] == "sample_chains"
    return res, {k: v for k, v in call["counters"].items()
                 if k.startswith("mh_graph.")}


@pytest.mark.parametrize("burn_in", [0, 1])
def test_the_graph_path_keeps_the_eager_bits_and_captures_once_a_key(
        sir, fake_graphs, burn_in):
    pf, prior_fns, transforms = sir
    first, counted = _sample(pf, _state(8, 11), 7, burn_in, prior_fns,
                             transforms)
    _assert_same(first, _sample_before(pf, _state(8, 11), 7, burn_in,
                                       prior_fns, transforms))
    # The first step runs eagerly, then the key captures.
    assert counted == {"mh_graph.capture": 1, "mh_graph.step": 5}
    assert first.state.step == 6
    second, counted = _sample(pf, first.state, 5, burn_in, prior_fns,
                              transforms)
    _assert_same(second, _sample_before(pf, first.state, 5, burn_in,
                                        prior_fns, transforms))
    assert counted == {"mh_graph.step": 4}
    # The state handed back is no tensor the graphs hold.
    (step,) = driver._STEPS.values()
    assert second.state.theta.data_ptr() != step.bound["theta"].data_ptr()
    assert second.state.ll.data_ptr() != step.bound["ll"].data_ptr()
    assert not step.busy


def test_a_filter_that_keeps_its_inputs_sees_each_steps_own(sir,
                                                            fake_graphs):
    pf, prior_fns, transforms = sir
    kept, copied = [], []

    def keeping(words, theta, n):
        kept.append((words, theta))
        return pf(words, theta, n)

    def copying(words, theta, n):
        copied.append((words.clone(), theta.clone()))
        return pf(words, theta, n)

    st = sample_chains(pf, _state(8, 12), 3, 0, prior_fns,
                       transforms).state
    res, counted = _sample(keeping, st, 6, 0, prior_fns, transforms)
    assert counted == {"mh_graph.step": 5}
    _assert_same(res, _sample_before(copying, st, 6, 0, prior_fns,
                                     transforms))
    assert len(kept) == len(copied) == 5
    for (w, th), (w0, th0) in zip(kept, copied):
        assert torch.equal(w, w0) and torch.equal(th, th0)


def test_a_capture_that_raises_leaves_the_key_eager(sir, fake_graphs):
    pf, prior_fns, transforms = sir
    fake_graphs.append(True)
    res, counted = _sample(pf, _state(8, 13), 5, 0, prior_fns, transforms)
    assert counted == {"mh_graph.fallback": 1}
    _assert_same(res, _sample_before(pf, _state(8, 13), 5, 0, prior_fns,
                                     transforms))
    again, counted = _sample(pf, res.state, 4, 0, prior_fns, transforms)
    assert counted == {}                    # not retried
    _assert_same(again, _sample_before(pf, res.state, 4, 0, prior_fns,
                                       transforms))


def test_a_filter_output_the_graph_cannot_take_finishes_the_call_eagerly(
        sir, fake_graphs):
    pf, prior_fns, transforms = sir

    def pf64(words, theta, n):
        ll, est = pf(words, theta, n)
        return ll.double(), est

    first = sample_chains(pf, _state(8, 14), 3, 0, prior_fns, transforms)
    res, counted = _sample(pf64, first.state, 5, 0, prior_fns, transforms)
    assert counted == {}
    assert res.state.ll.dtype == torch.float64
    _assert_same(res, _sample_before(pf64, first.state, 5, 0, prior_fns,
                                     transforms))
    # A key first stepped with such an output is not captured from it, so
    # a later call whose filter fits the key keeps its own bits.
    st = sample_chains(pf, _state(4, 14), 1, 0, prior_fns, transforms).state
    _, counted = _sample(pf64, st, 4, 0, prior_fns, transforms)
    assert counted == {}
    res, counted = _sample(pf, st, 4, 0, prior_fns, transforms)
    assert counted == {"mh_graph.capture": 1, "mh_graph.step": 2}
    assert res.state.ll.dtype == torch.float32
    _assert_same(res, _sample_before(pf, st, 4, 0, prior_fns, transforms))


def test_short_calls_and_state_estimates_run_eagerly(sir, fake_graphs):
    pf, prior_fns, transforms = sir
    _, counted = _sample(pf, _state(8, 15), 2, 0, prior_fns, transforms)
    assert counted == {} and not driver._STEPS
    res, counted = _sample(pf, _state(8, 15), 5, 0, prior_fns, transforms,
                           return_latent_state_est=True)
    assert counted == {} and not driver._STEPS
    assert res.latent.shape[:2] == (8, 5)


def test_the_cache_keeps_the_most_recent_keys(sir, fake_graphs):
    pf, _, transforms = sir
    _, log_priors, _ = sir_model()
    for k in range(driver.MH_GRAPH_KEYS + 2):
        priors = [lambda v, k=k: log_priors["lam"](v) - k,
                  log_priors["gamma"]]
        _, counted = _sample(pf, _state(4, 16), 3, 0, priors, transforms)
        assert counted == {"mh_graph.capture": 1, "mh_graph.step": 1}
    assert len(driver._STEPS) == driver.MH_GRAPH_KEYS


def test_the_benchmark_reads_the_share_of_replayed_steps(monkeypatch):
    from benchmark.lib.spec import load_cell

    read = load_cell("sir.sweep").reader("mh_graph_step_share")

    def call(steps, counters, profiled=False):
        return {"root": "sample_chains", "profiled": profiled, "spans": {},
                "counters": dict(counters, mh_steps=steps)}

    calls = []
    monkeypatch.setattr(timing, "recent_calls", lambda: list(calls))
    calls[:] = [call(64, {}), call(64, {})]
    assert read(None) is None           # a program without graph replay
    calls[:] = [call(64, {"mh_graph.capture": 1, "mh_graph.step": 63}),
                call(64, {"mh_graph.step": 64}),
                call(64, {"mh_graph.step": 64}),
                call(64, {}, profiled=True)]
    assert read(None) == 100.0
    calls[:] = [call(8, {"mh_graph.fallback": 1}), call(8, {}),
                call(8, {})]
    assert read(None) == 0.0


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(driver, "_STEPS", collections.OrderedDict())
    timing.reset()
    yield
    timing.reset()


def _card_sir(path, c, dev):
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    _, y = simulate_sir(seed=1405, n_total=500, init_infected=70, t_max=10)
    fns, log_priors, transform = sir_model(500, 70,
                                           transition="gillespie_pallas")
    names = ["lam", "gamma"]
    factory, model_fns = ((sir_sweep_pf_impl(500, 70), None)
                          if path == "sweep"
                          else (_make_pf_loglike, (*fns, None, None)))
    pf = factory(y.astype(np.float32), N, names, model_fns, None, "BPF",
                 "SISAR", "stratified", False, max_particles=N)
    return (pf, [log_priors[q] for q in names],
            resolve_transforms(transform, names))


def _eager(monkeypatch, *args, **kwargs):
    """``sample_chains`` with the halves called directly: no capture, in a
    cache of its own."""
    with monkeypatch.context() as mp:
        mp.setattr(driver, "_STEPS", collections.OrderedDict())
        mp.setattr(driver, "_capture", lambda propose, accept, dev: None)
        return sample_chains(*args, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("path,steps,burn_in", [
    ("sweep", 64, 0), ("sweep", 64, 1), ("engine", 16, 1)])
def test_card_graph_path_is_bitwise_the_eager_path(dev, fresh, monkeypatch,
                                                   path, steps, burn_in):
    pf, prior_fns, transforms = _card_sir(path, 4096, dev)
    st = _state(4096, 2**33 + 7, dev, (0.5, 0.2))
    want = _eager(monkeypatch, pf, st, steps + 1, burn_in, prior_fns,
                  transforms)
    got, counted = _sample(pf, st, steps + 1, burn_in, prior_fns,
                           transforms)
    assert counted == {"mh_graph.capture": 1, "mh_graph.step": steps - 1}
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    assert torch.equal(got.state.theta, want.state.theta)
    assert torch.equal(got.state.ll, want.state.ll)
    assert 0 < want.accepted.sum() < 4096 * steps
    # A second call with the same priors replays every step, capturing
    # nothing.
    want2 = _eager(monkeypatch, pf, want.state, steps + 1, burn_in,
                   prior_fns, transforms)
    got2, counted = _sample(pf, got.state, steps + 1, burn_in, prior_fns,
                            transforms)
    assert counted == {"mh_graph.step": steps}
    np.testing.assert_array_equal(got2.samples, want2.samples)
    np.testing.assert_array_equal(got2.accepted, want2.accepted)
    assert torch.equal(got2.state.ll, want2.state.ll)


@pytest.mark.cuda
def test_card_a_filter_that_keeps_its_inputs_sees_each_steps_own(
        dev, fresh, monkeypatch):
    pf, prior_fns, transforms = _card_sir("sweep", 4096, dev)
    kept, copied = [], []

    def keeping(words, theta, n):
        kept.append((words, theta))
        return pf(words, theta, n)

    def copying(words, theta, n):
        copied.append((words.clone(), theta.clone()))
        return pf(words, theta, n)

    st = _state(4096, 2**32 + 3, dev, (0.5, 0.2))
    got = sample_chains(keeping, st, 17, 0, prior_fns, transforms)
    want = _eager(monkeypatch, copying, st, 17, 0, prior_fns, transforms)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert len(kept) == len(copied) == 17    # the first filter, 16 steps
    for (w, th), (w0, th0) in zip(kept, copied):
        assert torch.equal(w, w0) and torch.equal(th, th0)


@pytest.mark.cuda
def test_card_a_prior_of_python_floats_falls_back(dev, fresh, monkeypatch):
    pf, prior_fns, transforms = _card_sir("sweep", 4096, dev)
    lam = prior_fns[0]
    priors = [lam, lambda v: -0.5]          # copied from the host
    st = _state(4096, 99, dev, (0.5, 0.2))
    got, counted = _sample(pf, st, 9, 0, priors, transforms)
    assert counted == {"mh_graph.fallback": 1}
    again, counted = _sample(pf, got.state, 5, 0, priors, transforms)
    assert counted == {}
    want = _eager(monkeypatch, pf, st, 9, 0, priors, transforms)
    want2 = _eager(monkeypatch, pf, want.state, 5, 0, priors, transforms)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(again.samples, want2.samples)
    assert torch.equal(again.state.ll, want2.state.ll)
    # The card still runs graphs for other keys after the failed capture.
    _, counted = _sample(pf, st, 4, 0, prior_fns, transforms)
    assert counted == {"mh_graph.capture": 1, "mh_graph.step": 2}
