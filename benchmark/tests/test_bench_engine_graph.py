"""The reader of ``engine_graph_call_share``: the share of the engine's
filter calls replayed as a CUDA graph, against made-up records of the
program's calls."""

from __future__ import annotations

import pytest

MS = 1_000_000


def _call(filters, counters, profiled=False, initial=0):
    """A ``sample_chains`` call with ``filters`` MH-step filter spans and
    ``initial`` initial evaluations."""
    spans = {"sample_chains/mh_step": {"count": filters,
                                       "total_ns": 3 * filters * MS,
                                       "self_ns": filters * MS},
             "sample_chains/mh_step/filter": {"count": filters,
                                              "total_ns": 2 * filters * MS,
                                              "self_ns": 2 * filters * MS}}
    if initial:
        spans["sample_chains/filter"] = {"count": initial, "total_ns": MS,
                                         "self_ns": MS}
    return {"root": "sample_chains", "profiled": profiled, "spans": spans,
            "counters": dict(counters, mh_steps=filters)}


@pytest.fixture
def calls(monkeypatch):
    from bayesssm_tpu_torch.utils import timing

    made_up = []
    monkeypatch.setattr(timing, "recent_calls", lambda: list(made_up))
    return made_up


def _read():
    from benchmark.lib.spec import load_cell

    return load_cell("sinusoidal.engine").reader("engine_graph_call_share")(
        None)


def test_the_share_is_the_median_over_the_unprofiled_calls(calls):
    calls[:] = [
        # The set-up call: its first filter direct, its second captured.
        _call(4, {"engine_graph.capture": 1, "engine_graph.replay": 3},
              initial=1),
        _call(4, {"engine_graph.replay": 4}),
        _call(4, {"engine_graph.replay": 4}),
        _call(4, {"engine_graph.replay": 4}),
        _call(4, {"engine_graph.replay": 2, "engine_graph.fallback": 2}),
        _call(4, {}, profiled=True),
    ]
    assert _read() == 100.0
    calls[:] = [_call(4, {"engine_graph.replay": 2,
                          "engine_graph.fallback": 2})] * 3
    assert _read() == 50.0


def test_a_program_that_counts_no_engine_graph_counter_gives_nothing(calls):
    calls[:] = [_call(16, {"mh_graph.step": 16}),
                _call(16, {"host_sync": 2})]
    assert _read() is None


def test_a_program_without_the_records_gives_nothing(monkeypatch):
    from bayesssm_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recent_calls")
    assert _read() is None
