"""The Lotka-Volterra Gillespie cell ``lvssa.sweep``: found by name with
what it names, its two readers on made-up records, the roofline's loop
term, and a whole CPU run at 8 chains over three observations, sound and
with the timed path broken underneath."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.lib.tracing import Trace
from test_bench_harness import _one_answer, _state_unchanged, _wrap_filter

# A whole run is thousands of ops on [8, 128] tensors: one thread a
# worker, or the workers' threads fight over the cores.
torch.set_num_threads(1)
NEW_METRICS = ("k1_ns_per_loop_iter", "k1_loop_lane_share")


def _tiny():
    from benchmark.lib.spec import load_cell

    cell = load_cell("lvssa.sweep")
    cell.config["t_max"] = 3
    cell.workload.update(chains=8, particles=100, lanes=128,
                         steps_per_call=2, trace_calls=1)
    return cell


def test_the_cell_loads_by_name_with_its_configuration():
    from benchmark.lib.spec import load_cell

    cell = load_cell("lvssa.sweep")
    assert cell.chips == 1
    cfg = cell.config
    assert cfg["model"] == "lvssa" and cfg["reduced"] == []
    assert (cfg["t_max"], cfg["obs_interval"], cfg["max_iters"]) == (
        15, 2.0, 100_000)
    assert set(cfg["assumed"]) == set(cfg["assumed_why"])
    wl = cell.workload
    assert (wl["chains"], wl["particles"], wl["lanes"], wl["filter"],
            wl["steps_per_call"]) == (4096, 100, 128, "sweep", 8)
    assert [m["name"] for m in cell.end_to_end] == ["mh_samples_per_s",
                                                    "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"device_ops_per_step", "k1_roofline_share",
                     "device_idle_share", "mh_step_mfu", "mh_step_self_ms",
                     "filter_call_ms", "host_syncs_per_step",
                     "sweep_issue_ms", "mh_graph_step_share", *NEW_METRICS}
    for other in ("sir.sweep", "sv.sweep", "lv.sweep", "sir.engine"):
        assert not set(NEW_METRICS) & {m["name"]
                                       for m in load_cell(other).per_layer}
    y = cell.reference().simulate(cfg)
    assert y.shape == (15, 2) and (y > 0).all()
    pf, priors = cell.program().build(cfg, "sweep", y, 100, 128)
    assert callable(pf) and len(priors) == 3
    with pytest.raises(ValueError, match="unknown LV-SSA filter path"):
        cell.program().build(cfg, "engine", y, 100, 128)
    with pytest.raises(ValueError, match="the LV-SSA callbacks take"):
        cell.program().build(dict(cfg, max_iters=10), "sweep", y, 100, 128)


def _sampling(k, profiled=False, counted=True):
    """A ``sample_chains`` call of 4 steps, 5 filter calls of 2 x 128
    lanes, each ~2,000 loop iterations a lane at 60% of the issued
    slots."""
    us = 1_000
    f = "sample_chains/mh_step/filter"
    spans = {"sample_chains": {"count": 1, "total_ns": 90 * k * us,
                               "self_ns": 0},
             "sample_chains/filter": {"count": 1, "total_ns": 10 * k * us,
                                      "self_ns": 0},
             f: {"count": 4, "total_ns": 40 * k * us, "self_ns": 0}}
    counters = {"mh_steps": 4, "sweep.lane_days": 5 * 2 * 128 * 3}
    if counted:
        counters["sweep.loop_iters"] = 5 * 2 * 128 * 2_000
        counters["sweep.loop_slots"] = counters["sweep.loop_iters"] * 5 // 3
    return {"id": k, "root": "sample_chains", "profiled": profiled,
            "ns": 90 * k * us, "spans": spans, "counters": counters}


def _trace():
    return Trace(kernels={"void bssm::sweep_kernel<bssm::GenModel>":
                          [0.0128, 5]},
                 counters={"bssm_sweep_generated": 5},
                 work=dict(model="lvssa", chains=2, lanes=128, particles=100,
                           days=3, events_per_filter=128 * 2_000))


@pytest.mark.parametrize("counted", [True, False])
def test_the_new_readers_on_made_up_records(counted, monkeypatch):
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    calls = [_sampling(1, counted=counted),
             _sampling(50, True, counted), _sampling(2, counted=counted)]
    monkeypatch.setattr(timing, "recent_calls", lambda: list(calls))
    cell = load_cell("lvssa.sweep")
    ns = cell.reader("k1_ns_per_loop_iter")(_trace())
    share = cell.reader("k1_loop_lane_share")(_trace())
    if not counted:
        # The records of a program without the loop's counters.
        assert ns is None and share is None
        return
    # 12.8 ms over 5 launches of 512,000 loop iterations.
    assert ns == pytest.approx(0.0128e9 / (5 * 512_000))
    assert share == pytest.approx(60.0)
    trace = _trace()
    trace.counters = {"bssm_sweep_sir": 5}
    assert cell.reader("k1_ns_per_loop_iter")(trace) is None
    roofline = cell.reader("k1_roofline_share")(_trace())
    assert 0.0 < roofline < 100.0


def test_the_new_readers_without_the_programs_records(monkeypatch):
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recent_calls")
    cell = load_cell("lvssa.sweep")
    for name in NEW_METRICS:
        assert cell.reader(name)(_trace()) is None


def test_the_rooflines_loop_term_doubles_with_the_events():
    from benchmark.roofline import lvssa

    live, t, n, c, events = 4096 * 100, 15, 128, 4096, 5.0e9
    arrivals = c * n * lvssa.arrivals_per_lane()
    base = lvssa.work(live, t, n, arrivals + events, c * n)
    doubled = lvssa.work(live, t, n, arrivals + 2 * events, c * n)
    assert doubled["events"][0] == 2 * base["events"][0] == 2 * events
    assert doubled["events"][1] == base["events"][1]
    assert doubled["arrivals"] == base["arrivals"]
    assert doubled["stage"] == base["stage"]


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
