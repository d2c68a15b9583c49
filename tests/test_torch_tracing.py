"""The port's tracing (``bayesssm_tpu_torch/utils/timing.py``): spans,
their paths and self time, counters, the per-call records, the phase
timer, and the ``bssm.*`` ranges it puts on ``torch.profiler``'s timeline.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bayesssm_tpu_torch as bt
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.utils import timing
from bayesssm_tpu_torch.utils.timing import PhaseTimer, count, span


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    assert timing._tls.stack == []      # every span opened was closed
    timing.reset()


def _fake_clock(monkeypatch, times):
    ticks = iter(times)
    monkeypatch.setattr(timing, "_clock", lambda: next(ticks))


def test_span_paths_counts_and_self_time_on_a_fake_clock(monkeypatch):
    _fake_clock(monkeypatch, [0, 10, 30, 40, 45, 50, 52, 58, 60, 100])
    with span("a"):
        with span("b"):
            pass
        with span("b"):
            pass
        with span("c"):
            with span("d"):
                pass
    (call,) = timing.recent_calls()
    assert call["root"] == "a" and call["ns"] == 100
    assert call["spans"] == {
        "a": {"count": 1, "total_ns": 100, "self_ns": 65},
        "a/b": {"count": 2, "total_ns": 25, "self_ns": 25},
        "a/c": {"count": 1, "total_ns": 10, "self_ns": 4},
        "a/c/d": {"count": 1, "total_ns": 6, "self_ns": 6},
    }


def test_a_span_closed_by_an_exception_is_still_counted(monkeypatch):
    _fake_clock(monkeypatch, [0, 1, 3, 7, 8, 9])
    with pytest.raises(KeyError):
        with span("root"):
            with span("inner"):
                raise KeyError("x")
    (call,) = timing.recent_calls()
    assert call["spans"]["root/inner"] == {"count": 1, "total_ns": 2,
                                           "self_ns": 2}
    assert call["spans"]["root"]["self_ns"] == 5
    with span("next"):
        pass
    assert timing.recent_calls()[-1]["spans"].keys() == {"next"}


def test_counters_are_kept_as_deltas_of_each_root_call():
    count("x", 5)
    with span("r"):
        count("x")
        count("y", 3)
        timing.host_sync(torch.zeros(1))            # the CPU: no wait
        timing.host_sync(torch.device("cuda", 0), 2)
    with span("r"):
        pass
    first, second = timing.recent_calls()
    assert first["counters"] == {"x": 1, "y": 3, "host_sync": 2}
    assert second["counters"] == {}
    assert second["id"] == first["id"] + 1
    assert not first["profiled"] and not second["profiled"]
    assert timing._tls.counters["x"] == 6


def test_the_record_keeps_the_last_calls_only():
    for _ in range(timing.RECENT_CALLS + 40):
        with span("r"):
            pass
    calls = timing.recent_calls()
    assert len(calls) == timing.RECENT_CALLS
    ids = [c["id"] for c in calls]
    assert ids == list(range(ids[0], ids[0] + timing.RECENT_CALLS))
    timing.reset()
    assert timing.recent_calls() == []


def test_spans_of_another_thread_are_roots_of_their_own():
    seen = []

    def worker():
        with span("worker"):
            pass
        seen.append(timing.recent_calls()[-1]["root"])

    with span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == ["worker"]
    assert timing.recent_calls()[-1]["spans"].keys() == {"main"}


def test_phase_timer_timings_are_unchanged(monkeypatch, capsys):
    _fake_clock(monkeypatch, [0, 2_500_000_000, 3_000_000_000,
                              3_250_000_000, 4_000_000_000, 5_000_000_000])
    timer = PhaseTimer(verbose=True, device="cpu")
    with timer.phase("tuning"):
        pass
    with timer.phase("sampling"):
        pass
    with timer.phase("sampling"):
        pass
    assert timer.timings == {"tuning": 2.5, "sampling": 1.25}
    assert "[timing] tuning: 2.50s" in capsys.readouterr().out
    assert [c["root"] for c in timing.recent_calls()] == [
        "tuning", "sampling", "sampling"]


def _events(prof) -> list:
    """``(start, end, name)`` of the profile's ``bssm.*`` ranges."""
    return sorted((e.time_range.start, e.time_range.end,
                   e.name[len(timing.SPAN_PREFIX):])
                  for e in prof.events()
                  if e.name.startswith(timing.SPAN_PREFIX))


def _event_paths(events) -> collections.Counter:
    """How many ranges lie at each path: the names of the ranges that
    contain a range, outermost first, and its own."""
    paths = collections.Counter()
    open_ = []                                      # (start, end, path)
    for a, b, name in sorted(events, key=lambda e: (e[0], -e[1])):
        while open_ and not (open_[-1][0] <= a and b <= open_[-1][1]):
            open_.pop()
        path = f"{open_[-1][2]}/{name}" if open_ else name
        paths[path] += 1
        open_.append((a, b, path))
    return paths


def _record_paths(call) -> collections.Counter:
    return collections.Counter({p: a["count"]
                                for p, a in call["spans"].items()})


def _lgss():
    fns, log_priors, transform = lgss_model()
    _, y = simulate_lgss(1405, t_val=6)
    return fns, log_priors, transform, y


def test_an_engine_filter_under_the_profiler_nests_as_its_spans():
    fns, _, _, y = _lgss()
    keys = torch.tensor([[0, 1], [0, 2]], dtype=torch.int64)
    theta = {"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.bootstrap_filter(keys, y, 16, *fns, theta=theta)
    (call,) = timing.recent_calls()
    assert call["root"] == "filter" and call["profiled"]
    paths = _event_paths(_events(prof))
    assert paths == _record_paths(call)
    assert paths["filter/day"] == len(y)
    assert {p.rsplit("/", 1)[-1] for p in paths} == {
        "filter", "keys", "day", "transition", "weight_step", "estimate"}


def test_pmmh_under_the_profiler_nests_as_its_spans():
    fns, log_priors, transform, y = _lgss()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.pmmh("bootstrap_filter", y, 6, *fns, log_priors,
                [{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}] * 2, 2,
                num_chains=2, param_transform=transform, seed=7,
                tune_control=bt.default_tune_control(
                    pilot_m=4, pilot_reps=3, pilot_n=20),
                device="cpu", print_summary=False)
    (call,) = timing.recent_calls()
    assert call["root"] == "pmmh" and call["profiled"]
    paths = _event_paths(_events(prof))
    assert paths == _record_paths(call)
    assert paths["pmmh/tuning/pilot/step"] == 3
    assert paths["pmmh/tuning/pilot/variance_run"] == 1
    assert paths["pmmh/proposal_factors"] == 1
    assert paths["pmmh/sampling/chunk/sample_chains/mh_step"] == 5
    assert paths["pmmh/sampling/chunk/sample_chains/mh_step/filter/day"] \
        == 5 * len(y)
    assert call["counters"]["mh_steps"] == 5


def test_with_no_profiler_no_record_function_is_opened(monkeypatch):
    opened = []
    real = timing._profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(timing._profiler, "record_function", spy)
    fns, _, _, y = _lgss()
    keys = torch.tensor([[0, 1]], dtype=torch.int64)
    theta = {"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}
    bt.bootstrap_filter(keys, y, 16, *fns, theta=theta)
    assert opened == []
    assert not timing.recent_calls()[-1]["profiled"]
    with profile(activities=[ProfilerActivity.CPU]):
        bt.bootstrap_filter(keys, y, 16, *fns, theta=theta)
    assert opened[0] == "bssm.filter" and len(opened) == 2 + 5 * len(y)


def test_sample_chains_counts_its_steps_and_the_host_waits_of_a_cpu_run(
        monkeypatch):
    from bayesssm_tpu_torch.pmmh import transforms
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    fns, log_priors, _, y = _lgss()
    names = list(log_priors)
    pf = _make_pf_loglike(y, 16, names, (*fns, None, None), None, "BPF",
                          "SISAR", "stratified", False, max_particles=16)
    state = init_chain_state(np.float32([0.5, 0.5, 0.5]),
                             np.tile(np.eye(3, dtype=np.float32) * 0.1,
                                     (3, 1, 1)), 16, 11, "cpu")
    monkeypatch.setattr(transforms, "_MASKS", {})
    sample_chains(pf, state, 5, 1, [log_priors[q] for q in names],
                  ("identity",) * 3)
    (call,) = timing.recent_calls()
    assert call["root"] == "sample_chains"
    # Four transform calls a step: the masks are built once, then reused.
    # Each of the 5 filters draws by threefry's plain twin on the CPU: two
    # key splits, the initial normals, and each day's normals and
    # resampling uniforms. Each filter day counts `engine.days`; the
    # portable weight step (no K3 on the CPU's "auto") counts no
    # `engine.k3_days`.
    assert call["counters"] == {"mh_steps": 4, "transform_consts.build": 1,
                                "transform_consts.hit": 15,
                                "threefry.plain": 5 * (3 + 2 * len(y)),
                                "engine.days": 5 * len(y)}
    assert call["spans"]["sample_chains/mh_step"]["count"] == 4
    assert call["spans"]["sample_chains/filter"]["count"] == 1
    assert call["spans"]["sample_chains/mh_step/filter"]["count"] == 4


def test_a_device_tally_lands_in_the_call_that_folds_it():
    """A tally's values reach the counters only at a fold after a stage,
    inside the root call that folds them, and the stage empties it."""
    tally = timing.DeviceTally(("loop.a", "loop.b"), "cpu")
    with span("first"):
        tally.feed().add_(torch.tensor([3, 40]))
        timing.fold_device_tallies()          # nothing staged yet
        timing.stage_device_tallies("cpu")
        tally.feed().add_(torch.tensor([1, 1]))  # after the stage: next call
        timing.fold_device_tallies()
    with span("second"):
        timing.stage_device_tallies("cpu")
        timing.fold_device_tallies()
        timing.fold_device_tallies()          # a fold takes a stage once
    first, second = timing.recent_calls()
    assert first["counters"] == {"loop.a": 3, "loop.b": 40}
    assert second["counters"] == {"loop.a": 1, "loop.b": 1}
    assert not tally.values.any()


def test_a_thread_stages_only_the_tallies_it_fed():
    """A tally the thread has not fed since its last stage, or that
    another thread fed, stays on its device; a tally staged and not yet
    folded waits for the next stage."""
    mine = timing.DeviceTally(("tally.mine",), "cpu")
    theirs = timing.DeviceTally(("tally.theirs",), "cpu")
    unfed = timing.DeviceTally(("tally.unfed",), "cpu")
    unfed.values += 5
    worker = threading.Thread(target=lambda: theirs.feed().add_(9))
    worker.start()
    worker.join()
    with span("call"):
        mine.feed().add_(2)
        timing.stage_device_tallies("cpu")
        mine.feed().add_(4)
        timing.stage_device_tallies("cpu")    # staged, not folded: waits
        timing.fold_device_tallies()
    with span("next"):
        timing.stage_device_tallies("cpu")
        timing.fold_device_tallies()
    first, second = timing.recent_calls()
    assert first["counters"] == {"tally.mine": 2}
    assert second["counters"] == {"tally.mine": 4}
    assert int(theirs.values) == 9 and int(unfed.values) == 5


def test_sample_chains_folds_the_device_tallies_at_its_end():
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains

    tally = timing.DeviceTally(("loop.iters",), "cpu")

    def pf(seed_words, theta, n):
        tally.feed().add_(7)
        return torch.zeros(theta.shape[0]), torch.zeros(theta.shape[0], 2)

    state = init_chain_state(np.float32([0.5]), np.full((2, 1, 1), 0.1,
                                                        np.float32),
                             16, 3, "cpu")
    prior = [lambda x: torch.zeros_like(x)]
    sample_chains(pf, state, 4, 0, prior, ("identity",))
    (call,) = timing.recent_calls()
    # The initial evaluation and three MH steps.
    assert call["counters"]["loop.iters"] == 4 * 7
    assert "host_sync" not in call["counters"]
