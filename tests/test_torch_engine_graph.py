"""The engine's filter as one CUDA graph per key
(``bayesssm_tpu_torch/pmmh/tuning.py``: ``_make_pf_loglike``,
``_FilterGraph``).

On the CPU the path the card runs (a key's direct first call, the capture
on its second, replays after it, the cache of keys, the busy flag, the
fallbacks and the launch and counter bookkeeping) runs with captures that
run their function instead of recording it (``fake_graphs``); without
them the CPU and a particle axis never capture. On the card (``-m cuda``,
skipped here): real captures of the sinusoidal and SIR engines, each
replay bit for bit with a direct call, and an RMPF filter that replays
bit for bit or falls back once. The file imports no JAX, so the card
runs it with ``--noconftest``.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
)
from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.pmmh import tuning
from bayesssm_tpu_torch.pmmh.tuning import ENGINE_GRAPH_KEYS, _make_pf_loglike
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

N, T = 128, 5
NAMES = ["phi", "sigma_x", "sigma_y"]


def _pf(fns=None, t=T, **kwargs):
    _, y = simulate_sinusoidal(seed=1405, t_val=t)
    fns = fns or sinusoidal_model()[0]
    return _make_pf_loglike(np.asarray(y, np.float32), N, NAMES,
                            (*fns, None, None), None, "BPF", "SISAR",
                            "stratified", False, max_particles=N, **kwargs)


def _inputs(c, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    words = torch.as_tensor(rng.integers(0, 2**32, (c, 2), dtype=np.uint64)
                            .astype(np.int64), device=dev)
    theta = torch.as_tensor((np.array([0.8, 1.0, 0.5], np.float32) * np.exp(
        0.1 * rng.normal(size=(c, 3)))).astype(np.float32), device=dev)
    n = torch.full((c,), float(N - 3 * (seed % 2)), device=dev)
    return words, theta, n


def _call(pf, *args):
    """``pf(*args)`` as a root call: its outputs, its counters' changes
    and its spans."""
    with timing.span("call"):
        out = pf(*args)
    call = timing.recent_calls()[-1]
    return out, call["counters"], call["spans"]


def _graph_counts(counters):
    return {k: v for k, v in counters.items() if k.startswith("engine_graph.")}


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def direct():
    """A closure called with graphs off: every call runs directly, as on
    the CPU."""
    pf = _pf()

    def call(*args):
        on = tuning._graphs_on
        tuning._graphs_on = lambda dev: False
        try:
            return pf(*args)
        finally:
            tuning._graphs_on = on

    return call


class _FakeGraph:
    """A capture that runs its function, and a replay that runs it again on
    the inputs the capture was given and writes into the first run's
    outputs, as a replay writes into the captured outputs. Its runs count
    no launches and no counters: the kernels of a graph launch through no
    launcher."""

    def __init__(self, run, inputs, log):
        self.run, self.inputs, self.log = run, inputs, log
        self.out = run(*inputs)
        self.replaying = False

    def replay(self):
        assert not self.replaying, "two calls replay one graph at once"
        self.replaying = True
        try:
            self.log.append("replay")
            before = tuning._tally()
            new = self.run(*self.inputs)
            tuning._add(tuning._gained(before), -1)
            for old, value in zip(self.out, new):
                old.copy_(value)
        finally:
            self.replaying = False


@pytest.fixture
def fake_graphs(monkeypatch):
    """The card's path on the CPU; append ``"fail"`` to make captures raise
    as a capture of host work does. Yields the log of captures and
    replays."""
    log = []

    def capture(run, inputs):
        log.append("capture")
        if "fail" in log:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        graph = _FakeGraph(run, inputs, log)
        return graph, graph.out

    monkeypatch.setattr(tuning, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(tuning, "_capture_filter", capture)
    timing.reset()
    yield log
    timing.reset()


# ---------------------------------------------------------------- CPU


def test_a_key_captures_on_its_second_call_and_replays_after(fake_graphs,
                                                             direct):
    pf = _pf()
    counted = []
    for seed in range(5):
        args = _inputs(16, seed)
        got, counters, _ = _call(pf, *args)
        _assert_equal(got, direct(*args))
        counted.append(_graph_counts(counters))
    assert counted == [{}, {"engine_graph.capture": 1,
                            "engine_graph.replay": 1},
                       *[{"engine_graph.replay": 1}] * 3]
    assert fake_graphs == ["capture", "replay", "replay", "replay",
                           "replay"]
    (entry,) = pf.graphs.values()
    assert not entry.busy


def test_replays_equal_direct_calls_and_are_not_aliased(fake_graphs,
                                                        direct):
    pf = _pf()
    for seed in range(2):
        pf(*_inputs(16, seed))
    outs = [pf(*_inputs(16, seed)) for seed in (2, 3, 4)]
    (entry,) = pf.graphs.values()
    for seed, out in zip((2, 3, 4), outs):
        # Kept across later replays, and none of the graph's own tensors.
        _assert_equal(out, direct(*_inputs(16, seed)))
        for t, held in zip(out, entry.outputs):
            assert t.data_ptr() != held.data_ptr()
    assert not torch.equal(outs[0][0], outs[1][0])


def test_an_int_particle_count_is_baked_into_its_own_key(fake_graphs,
                                                         direct):
    pf = _pf()
    for seed in range(4):
        words, theta, _ = _inputs(8, seed)
        _assert_equal(pf(words, theta), direct(words, theta))
        _assert_equal(pf(words, theta, 100), direct(words, theta, 100))
    assert fake_graphs.count("capture") == 2
    assert [k[-1] for k in pf.graphs] == [N, 100]


def test_one_key_a_shape_and_the_cache_keeps_the_most_recent(fake_graphs):
    pf = _pf(t=2)
    sizes = range(2, 2 + ENGINE_GRAPH_KEYS + 2)
    for c in sizes:
        for seed in range(2):
            pf(*_inputs(c, seed))
    assert fake_graphs.count("capture") == len(sizes)
    assert len(pf.graphs) == ENGINE_GRAPH_KEYS
    assert [k[1] for k in pf.graphs] == [(c, 2) for c in sizes][-4:]
    # An evicted key starts again: a direct call, then a capture.
    _, counters, _ = _call(pf, *_inputs(2, 0))
    assert _graph_counts(counters) == {}
    _, counters, _ = _call(pf, *_inputs(2, 1))
    assert _graph_counts(counters) == {"engine_graph.capture": 1,
                                       "engine_graph.replay": 1}


def test_a_key_another_call_holds_runs_directly(fake_graphs, direct):
    pf = _pf()
    pf(*_inputs(16, 0))
    (entry,) = pf.graphs.values()
    entry.busy = True
    args = _inputs(16, 1)
    got, counters, _ = _call(pf, *args)
    _assert_equal(got, direct(*args))
    assert _graph_counts(counters) == {"engine_graph.fallback": 1}
    assert fake_graphs == [] and entry.busy
    entry.busy = False
    _, counters, _ = _call(pf, *args)
    assert _graph_counts(counters) == {"engine_graph.capture": 1,
                                       "engine_graph.replay": 1}


def _stub_core(**kw):
    """A filter of a few ops, for tests of the bookkeeping around it."""
    theta = torch.stack(list(kw["theta"].values()), dim=1)
    return types.SimpleNamespace(
        loglike=theta.sum(dim=1) + kw["key"][:, 0].to(torch.float32),
        state_est=theta * 2.0)


def test_threads_sharing_a_key_never_replay_it_at_once(fake_graphs,
                                                       monkeypatch):
    monkeypatch.setattr(tuning, "particle_filter_core", _stub_core)
    pf = _pf()
    pf(*_inputs(4, 0))
    pf(*_inputs(4, 1))
    errors, results = [], {}

    def worker(w):
        try:
            for i in range(10):
                seed = 10 + 10 * w + i
                results[seed] = pf(*_inputs(4, seed))
        except BaseException as e:      # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(results) == 16 * 10
    for seed, got in results.items():
        words, theta, _ = _inputs(4, seed)
        want = _stub_core(key=words, theta=dict(zip(NAMES, theta.T)))
        _assert_equal(got, (want.loglike, want.state_est))
    assert fake_graphs.count("capture") == 1
    assert not next(iter(pf.graphs.values())).busy


def test_a_capture_that_raises_leaves_the_key_direct(fake_graphs, direct):
    pf = _pf()
    fake_graphs.append("fail")
    pf(*_inputs(16, 0))
    before = dict(_build.launches)
    got, counters, _ = _call(pf, *_inputs(16, 1))
    _assert_equal(got, direct(*_inputs(16, 1)))
    assert _graph_counts(counters) == {"engine_graph.fallback": 1}
    # The failed capture counts nothing; the direct call its own.
    _, plain, _ = _call(direct, *_inputs(16, 1))
    assert {k: v for k, v in counters.items()
            if not k.startswith("engine_graph.")} == plain
    assert dict(_build.launches) == before
    for seed in (2, 3):
        got, counters, _ = _call(pf, *_inputs(16, seed))
        _assert_equal(got, direct(*_inputs(16, seed)))
        assert _graph_counts(counters) == {}        # not retried
    assert fake_graphs.count("capture") == 1


def test_a_direct_call_that_waited_on_the_host_never_captures(fake_graphs,
                                                              direct):
    init_fn, transition_fn, log_likelihood_fn = sinusoidal_model()[0]

    def waiting_transition(key, particles, phi, sigma_x):
        timing.count("host_sync")     # as host_sync does on a card
        return transition_fn(key=key, particles=particles, phi=phi,
                             sigma_x=sigma_x)

    pf = _pf((init_fn, waiting_transition, log_likelihood_fn))
    _, counters, _ = _call(pf, *_inputs(16, 0))
    assert _graph_counts(counters) == {"engine_graph.fallback": 1}
    for seed in (1, 2, 3):
        got, counters, _ = _call(pf, *_inputs(16, seed))
        _assert_equal(got, direct(*_inputs(16, seed)))
        assert _graph_counts(counters) == {}
    assert fake_graphs == []


def test_the_cpu_never_captures(monkeypatch, direct):
    captures = []
    monkeypatch.setattr(tuning, "_capture_filter",
                        lambda run, inputs: captures.append(inputs))
    pf = _pf()
    timing.reset()
    for seed in range(3):
        got, counters, _ = _call(pf, *_inputs(16, seed))
        _assert_equal(got, direct(*_inputs(16, seed)))
        assert _graph_counts(counters) == {}
    assert captures == [] and not pf.graphs
    timing.reset()


def test_a_particle_axis_never_captures(fake_graphs, monkeypatch):
    seen = []

    def core(**kw):
        seen.append(kw["particle_axis"])
        return _stub_core(**kw)

    monkeypatch.setattr(tuning, "particle_filter_core", core)
    pf = _pf(particle_axis="particles", particle_axis_size=1)
    for seed in range(3):
        _, counters, _ = _call(pf, *_inputs(16, seed))
        assert _graph_counts(counters) == {}
    assert seen == ["particles"] * 3
    assert fake_graphs == [] and not pf.graphs


def _counting_fns():
    """The sinusoidal model with a transition and a weight that count as
    the card's launchers do: a launch of K4 and of K3, and
    ``threefry.kernel``, each call."""
    init_fn, transition_fn, log_likelihood_fn = sinusoidal_model()[0]

    def transition(key, particles, phi, sigma_x):
        _build.launches["bssm_gillespie"] += 1
        timing.count("threefry.kernel")
        return transition_fn(key=key, particles=particles, phi=phi,
                             sigma_x=sigma_x)

    def log_likelihood(y, particles, sigma_y):
        _build.launches["bssm_fused_resample"] += 1
        return log_likelihood_fn(y=y, particles=particles, sigma_y=sigma_y)

    return init_fn, transition, log_likelihood


def test_replays_count_what_the_direct_call_counted(fake_graphs):
    pf = _pf(_counting_fns())

    def launched(args):
        before = dict(_build.launches)
        out, counters, _ = _call(pf, *args)
        return out, {k: v - before[k] for k, v in _build.launches.items()
                     if v != before[k]}, counters

    _, direct_launches, direct_counters = launched(_inputs(16, 0))
    assert direct_launches == {"bssm_gillespie": T,
                               "bssm_fused_resample": T}
    assert direct_counters["threefry.kernel"] == T
    # The capture counts nothing; its call's replay and every later one
    # count what the direct call did.
    for seed, extra in [(1, {"engine_graph.capture": 1,
                             "engine_graph.replay": 1}),
                        (2, {"engine_graph.replay": 1}),
                        (3, {"engine_graph.replay": 1})]:
        _, launches, counters = launched(_inputs(16, seed))
        assert launches == direct_launches
        assert counters == dict(direct_counters, **extra)


def test_a_replay_is_one_filter_span_and_a_capture_its_own(fake_graphs):
    # The fake's runs open the engine's spans inside these; on the card a
    # replay runs no day span (the card test).
    pf = _pf()
    _, _, spans = _call(pf, *_inputs(16, 0))
    assert spans["call/filter"]["count"] == 1
    assert spans["call/filter/day"]["count"] == T
    _, _, spans = _call(pf, *_inputs(16, 1))
    assert "call/filter" not in spans
    assert spans["call/engine_capture"]["count"] == 1
    _, _, spans = _call(pf, *_inputs(16, 2))
    assert spans["call/filter"]["count"] == 1
    assert "call/engine_capture" not in spans


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _card_pf(model, dev):
    """``(pf, direct, chains, parameters, lanes)``: an engine closure and
    another for direct calls, at the card test's size."""
    if model == "sinusoidal":
        _, y = simulate_sinusoidal(seed=1405, t_val=20)
        fns, names, n, c = sinusoidal_model()[0], NAMES, 1024, 256
        extra = (None, None)
    else:
        from bayesssm_tpu_torch.models.sir import (
            simulate_sir,
            sir_model,
            sir_move_fn,
        )

        _, y = simulate_sir(seed=1405, n_total=500, init_infected=70,
                            t_max=10)
        fns, names, n, c = (sir_model(500, 70,
                                      transition="gillespie_pallas")[0],
                            ["lam", "gamma"], 128, 256)
        extra = (None, sir_move_fn(500)) if model == "sir_rmpf" else (
            None, None)
    algorithm = "RMPF" if model == "sir_rmpf" else "BPF"

    def make():
        return _make_pf_loglike(np.asarray(y, np.float32), n, names,
                                (*fns, *extra), None, algorithm, "SISAR",
                                "stratified", False, max_particles=n)

    return make(), make(), c, len(names), n


def _card_inputs(c, p, n, seed, dev):
    rng = np.random.default_rng(seed)
    words = torch.as_tensor(rng.integers(0, 2**32, (c, 2), dtype=np.uint64)
                            .astype(np.int64), device=dev)
    base = np.array([0.8, 1.0, 0.5] if p == 3 else [0.5, 0.2], np.float32)
    theta = torch.as_tensor((base * np.exp(0.1 * rng.normal(size=(c, p))))
                            .astype(np.float32), device=dev)
    count = torch.full((c,), float(n - 24 * (seed % 2)), device=dev)
    return words, theta, count


def _direct_call(monkeypatch, pf, *args):
    with monkeypatch.context() as mp:
        mp.setattr(tuning, "_graphs_on", lambda dev: False)
        before = dict(_build.launches)
        out = pf(*args)
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in _build.launches.items()
                     if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sinusoidal", "sir"])
def test_card_replays_are_bitwise_the_direct_calls(dev, monkeypatch, model):
    pf, direct, c, p, n = _card_pf(model, dev)
    timing.reset()
    _, one = _direct_call(monkeypatch, direct, *_card_inputs(c, p, n, 0,
                                                            dev))
    assert one
    kept = []
    for seed in range(6):
        args = _card_inputs(c, p, n, seed, dev)
        before = dict(_build.launches)
        (got, counters, spans) = _call(pf, *args)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _build.launches.items()
                    if v != before[k]}
        want, _ = _direct_call(monkeypatch, direct, *args)
        _assert_equal(got, want)
        kept.append((got, want))
        assert launched == one
        graph = _graph_counts(counters)
        if seed == 0:
            assert graph == {}
        elif seed == 1:
            assert graph == {"engine_graph.capture": 1,
                             "engine_graph.replay": 1}
        else:
            assert graph == {"engine_graph.replay": 1}
            assert spans["call/filter"]["count"] == 1
            assert not any("/day" in path for path in spans)
    for got, want in kept:          # no result was overwritten
        _assert_equal(got, want)
    assert not torch.equal(kept[-1][0][0], kept[-2][0][0])
    timing.reset()


@pytest.mark.cuda
def test_card_rmpf_replays_bitwise_or_falls_back_once(dev, monkeypatch):
    pf, direct, c, p, n = _card_pf("sir_rmpf", dev)
    timing.reset()
    counted = {}
    for seed in range(4):
        args = _card_inputs(c, p, n, seed, dev)
        got, counters, _ = _call(pf, *args)
        want, _ = _direct_call(monkeypatch, direct, *args)
        _assert_equal(got, want)
        for k, v in _graph_counts(counters).items():
            counted[k] = counted.get(k, 0) + v
    assert counted in ({"engine_graph.capture": 1, "engine_graph.replay": 3},
                       {"engine_graph.fallback": 1})
    timing.reset()
