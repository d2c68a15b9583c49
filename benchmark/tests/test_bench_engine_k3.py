"""The reader of ``engine_k3_day_share``: the share of the engine's days
whose weight step ran whole inside K3, against made-up records of the
program's calls."""

from __future__ import annotations

import pytest


def _call(counters, profiled=False):
    """A ``sample_chains`` call of 4 MH steps with the given counters."""
    spans = {"sample_chains/mh_step/filter": {"count": 4, "total_ns": 8,
                                              "self_ns": 8}}
    return {"root": "sample_chains", "profiled": profiled, "spans": spans,
            "counters": dict(counters, mh_steps=4)}


@pytest.fixture
def calls(monkeypatch):
    from bayesssm_tpu_torch.utils import timing

    made_up = []
    monkeypatch.setattr(timing, "recent_calls", lambda: list(made_up))
    return made_up


def _read(cell="sinusoidal.engine"):
    from benchmark.lib.spec import load_cell

    return load_cell(cell).reader("engine_k3_day_share")(None)


@pytest.mark.parametrize("cell", ["sir.engine", "sinusoidal.engine"])
def test_every_day_in_k3_reads_100(calls, cell):
    calls[:] = [_call({"engine.days": 80, "engine.k3_days": 80})] * 3
    assert _read(cell) == 100.0


def test_the_share_is_the_median_over_the_unprofiled_calls(calls):
    calls[:] = [
        _call({"engine.days": 80, "engine.k3_days": 80}),
        _call({"engine.days": 80, "engine.k3_days": 40}),
        _call({"engine.days": 80, "engine.k3_days": 20}),
        _call({"engine.days": 80}, profiled=True),
        _call({"engine.days": 80}, profiled=True),
    ]
    assert _read() == 50.0
    calls[:] = [_call({"engine.days": 40})] * 2
    assert _read() == 0.0


def test_a_program_that_never_counts_engine_days_gives_nothing(calls):
    calls[:] = [_call({"engine_graph.replay": 4}),
                _call({"mh_graph.step": 4, "host_sync": 2})]
    assert _read() is None


def test_a_program_without_the_records_gives_nothing(monkeypatch):
    from bayesssm_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recent_calls")
    assert _read() is None
