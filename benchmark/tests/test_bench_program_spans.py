"""The per-layer metrics that read the program's own spans and counters
(``benchmark/lib/program_spans.py``): each reader against a made-up
record of calls, and a traced CPU run of the sampling cells that reports
every one of them."""

from __future__ import annotations

import math
import time

import pytest
import torch

from conftest import tiny_cell

SPAN_METRICS = ("mh_step_self_ms", "filter_call_ms", "engine_keys_ms_per_call",
                "engine_transition_ms_per_call",
                "engine_weight_step_ms_per_call", "host_syncs_per_step",
                "pilot_ms_per_step", "proposal_factors_ms")


def _agg(count, total, own=None):
    return {"count": count, "total_ns": total,
            "self_ns": total if own is None else own}


def _sampling(k, profiled=False):
    """A ``sample_chains`` call whose numbers scale with ``k``: 4 steps,
    5 filters, 10 days a filter."""
    ms = 1_000_000
    day = "sample_chains/mh_step/filter/day"
    return {"id": k, "root": "sample_chains", "profiled": profiled,
            "ns": 100 * k * ms,
            "spans": {
                "sample_chains": _agg(1, 100 * k * ms, 2 * ms),
                "sample_chains/filter": _agg(1, 10 * k * ms, 0),
                "sample_chains/mh_step": _agg(4, 88 * k * ms, 8 * k * ms),
                "sample_chains/mh_step/filter": _agg(4, 40 * k * ms, 0),
                "sample_chains/mh_step/filter/keys": _agg(4, 2 * k * ms),
                f"{day}/keys": _agg(40, 3 * k * ms),
                f"{day}/transition": _agg(40, 20 * k * ms),
                f"{day}/weight_step": _agg(40, 15 * k * ms),
            },
            "counters": {"mh_steps": 4, "host_sync": 2 * k}}


def _pmmh(k, profiled=False):
    ms = 1_000_000
    return {"id": 100 + k, "root": "pmmh", "profiled": profiled,
            "ns": 5000 * k * ms,
            "spans": {"pmmh": _agg(1, 5000 * k * ms),
                      "pmmh/tuning/pilot/step": _agg(199, 199 * 9 * k * ms),
                      "pmmh/proposal_factors": _agg(1, 100 * k * ms)},
            "counters": {"host_sync": 3000}}


# Per-call values of the made-up calls at k = 1: the readers take the
# median over k = 1, 2, 4 (2x these) and leave out the profiled k = 50.
AT_ONE = {"mh_step_self_ms": 2.0, "filter_call_ms": 10.0,
          "engine_keys_ms_per_call": 1.0, "engine_transition_ms_per_call": 4.0,
          "engine_weight_step_ms_per_call": 3.0, "host_syncs_per_step": 0.5,
          "pilot_ms_per_step": 9.0, "proposal_factors_ms": 100.0}


@pytest.fixture
def records(monkeypatch):
    from bayesssm_tpu_torch.utils import timing

    calls = [_sampling(1), _sampling(4), _sampling(50, profiled=True),
             _sampling(2), _pmmh(1), _pmmh(50, profiled=True), _pmmh(4),
             _pmmh(2)]
    monkeypatch.setattr(timing, "recent_calls", lambda: list(calls))
    return calls


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_takes_the_median_of_the_unprofiled_calls(name, records):
    from benchmark.lib.spec import load_cell

    cell = load_cell("sir.pmmh" if name.startswith(("pilot", "proposal"))
                     else "sir.engine")
    assert cell.reader(name)(None) == pytest.approx(2 * AT_ONE[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_of_a_program_without_the_records_gives_nothing(
        name, monkeypatch):
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recent_calls")
    assert load_cell("sir.engine").reader(name)(None) is None


@pytest.mark.parametrize("name", ["sir.sweep", "sir.engine"])
def test_a_traced_cpu_run_reports_every_span_metric_of_the_cell(
        name, card_paths):
    from benchmark import run
    from bayesssm_tpu_torch.utils import timing

    timing.reset()
    cell = tiny_cell(name)
    listed = [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS]
    assert len(listed) == {"sir.sweep": 3, "sir.engine": 6}[name]
    result = run.run_cell(cell, 2**33 + 9, 0.5, True, torch.device("cpu"),
                          time.perf_counter())
    assert result["correct"] is True
    for metric in listed:
        value = result["metrics"][metric]["value"]
        assert math.isfinite(value) and value >= 0, metric
