"""The stochastic-volatility cell ``sv.sweep``: found by name with what it
names, the readers of the sweep's issue time and of K1's time a lane-day
on made-up records, and a whole CPU run at 8 chains, sound and with the
timed path broken underneath."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.lib.tracing import Trace
from test_bench_harness import _one_answer, _state_unchanged, _wrap_filter

# A whole run at 945 days is thousands of ops on [8, 128] tensors: one
# thread a worker, or the workers' threads fight over the cores.
torch.set_num_threads(1)
NEW_METRICS = ("sweep_issue_ms", "k1_ns_per_lane_day")


def _tiny():
    from benchmark.lib.spec import load_cell

    cell = load_cell("sv.sweep")
    cell.workload.update(chains=8, particles=100, lanes=128,
                         steps_per_call=2, trace_calls=1)
    return cell


def test_the_cell_loads_by_name_with_its_configuration():
    from benchmark.lib.spec import load_cell

    cell = load_cell("sv.sweep")
    assert cell.chips == 1
    assert cell.config["model"] == "sv" and cell.config["t_max"] == 945
    assert cell.config["reduced"] == []
    assert set(cell.config["assumed"]) == set(cell.config["assumed_why"])
    wl = cell.workload
    assert (wl["chains"], wl["particles"], wl["lanes"], wl["filter"]) == (
        4096, 1000, 1024, "sweep")
    assert [m["name"] for m in cell.end_to_end] == ["mh_samples_per_s",
                                                    "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"device_ops_per_step", "k1_roofline_share",
                     "device_idle_share", "mh_step_mfu", "mh_step_self_ms",
                     "filter_call_ms", "host_syncs_per_step", *NEW_METRICS}
    assert NEW_METRICS[0] in {m["name"]
                              for m in load_cell("sir.sweep").per_layer}
    assert not set(NEW_METRICS) & {m["name"]
                                   for m in load_cell("sir.engine").per_layer}
    pf, priors = cell.program().build(
        cell.config, "sweep", cell.reference().simulate(cell.config), 100,
        128)
    assert callable(pf) and len(priors) == 3
    with pytest.raises(ValueError, match="unknown SV filter path"):
        cell.program().build(cell.config, "engine", None, 100, 128)


def _sampling(k, profiled=False, sweep=True):
    """A ``sample_chains`` call of 4 steps, 5 filter calls: ``prepare``
    3k us and ``launch`` 7k us a filter; 5 launches of 2 x 128 x 10
    lane-days."""
    us = 1_000
    f = "sample_chains/mh_step/filter"
    spans = {"sample_chains": {"count": 1, "total_ns": 90 * k * us,
                               "self_ns": 0},
             "sample_chains/filter": {"count": 1, "total_ns": 10 * k * us,
                                      "self_ns": 0},
             f: {"count": 4, "total_ns": 40 * k * us, "self_ns": 0}}
    counters = {"mh_steps": 4}
    if sweep:
        for outer, n in (("sample_chains/filter", 1), (f, 4)):
            for leaf, us_each in (("prepare", 3), ("launch", 7)):
                ns = us_each * n * k * us
                spans[f"{outer}/{leaf}"] = {"count": n, "total_ns": ns,
                                            "self_ns": ns}
        counters["sweep.lane_days"] = 5 * 2 * 128 * 10
    return {"id": k, "root": "sample_chains", "profiled": profiled,
            "ns": 90 * k * us, "spans": spans, "counters": counters}


def _trace():
    return Trace(kernels={"void bssm::sweep_kernel<bssm::GenModel>":
                          [0.0128, 5]},
                 counters={"bssm_sweep_generated": 5},
                 work=dict(model="sv", chains=2, lanes=128, particles=100,
                           days=10, events_per_filter=0.0))


@pytest.mark.parametrize("sweep", [True, False])
def test_the_new_readers_on_made_up_records(sweep, monkeypatch):
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    calls = [_sampling(1, sweep=sweep), _sampling(50, True, sweep),
             _sampling(2, sweep=sweep), _sampling(4, sweep=sweep)]
    monkeypatch.setattr(timing, "recent_calls", lambda: list(calls))
    cell = load_cell("sv.sweep")
    issue = cell.reader("sweep_issue_ms")(_trace())
    ns = cell.reader("k1_ns_per_lane_day")(_trace())
    if not sweep:
        # The records of a program without the sweep's spans and counter.
        assert issue is None and ns is None
        return
    # Median over k = 1, 2, 4 of 10k us a filter; 12.8 ms over 5 launches
    # of 2560 lane-days.
    assert issue == pytest.approx(0.02)
    assert ns == pytest.approx(0.0128e9 / (5 * 2560))
    trace = _trace()
    trace.counters = {"bssm_sweep_sir": 5}
    assert cell.reader("k1_ns_per_lane_day")(trace) is None


def test_the_new_readers_without_the_programs_records(monkeypatch):
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recent_calls")
    cell = load_cell("sv.sweep")
    for name in NEW_METRICS:
        assert cell.reader(name)(_trace()) is None


@pytest.mark.parametrize("fault", [None, "state_unchanged", "one_answer"])
def test_a_cpu_run_is_correct_only_when_the_timed_path_is_sound(
        fault, monkeypatch):
    from benchmark import run

    cell = _tiny()
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "one_answer":
        _wrap_filter(monkeypatch, cell, _one_answer)
    result = run.run_cell(cell, 2**33 + 71, 0.5, False, torch.device("cpu"),
                          time.perf_counter())
    assert result["correct"] is (fault is None)
    if fault is None:
        assert all(c["value"] == 0.0 for c in result["checks"].values())
        assert set(result["metrics"]) == {"mh_samples_per_s", "setup_s"}
