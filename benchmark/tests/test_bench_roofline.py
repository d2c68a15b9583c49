"""The frozen roofline copy against the bounds the system's smoke script
printed (PERF.md, the kernel table): K3 at 4096 x 128 x 2 and K1c at
4096 x 128 x 20, every lane alive; and each family's bounds found by its
name, in a file of its own."""

from __future__ import annotations

import pathlib
import sys

import pytest

from benchmark.roofline import k3, k4, peaks, sinusoidal, sir, step
from benchmark.lib.tracing import Trace


def test_k3_bound_at_the_table_shape():
    seconds, by = k3.weight_step(4096, 128, 2, 4096 * 128)
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(0.00441, abs=5e-6)


def test_k1c_bound_at_the_table_shape():
    seconds, by = sinusoidal.filter_bound(4096, 128, 4096 * 128, 20)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(0.1247, abs=5e-5)


def test_step_bound_is_the_filter_work_whatever_the_kernels():
    events = 3.2e6
    assert step.filter_bound("sir", 4096, 128, 4096 * 128, 10, events) == \
        sir.filter_bound(4096, 128, 4096 * 128, 10, events)
    assert step.filter_bound("sinusoidal", 4096, 1024, 4096 * 1000, 20) == \
        sinusoidal.filter_bound(4096, 1024, 4096 * 1000, 20)


def test_a_family_added_as_a_file_is_found_by_its_name(tmp_path,
                                                       monkeypatch):
    from benchmark import roofline
    from benchmark.lib.spec import load_file

    (tmp_path / "toy.py").write_text(
        "SWEEP_COUNTER = 'bssm_sweep_toy'\n"
        "def filter_bound(c, n, live, t, events=0.0):\n"
        "    return (1e-3 * t, 'operations')\n")
    monkeypatch.setattr(roofline, "__path__",
                        [*roofline.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "benchmark.roofline.toy", raising=False)
    assert step.filter_bound("toy", 8, 128, 8 * 128, 5) == (5e-3,
                                                             "operations")
    metrics = pathlib.Path(step.__file__).parents[1] / "metrics"
    reader = load_file(metrics / "k1_roofline_share.py", "k1_probe").read
    trace = Trace(kernels={"sweep_kernel<ToyModel>": [0.04, 4]},
                  counters={"bssm_sweep_toy": 4},
                  work=dict(model="toy", chains=8, lanes=128, particles=100,
                            days=5, events_per_filter=0.0))
    assert reader(trace) == pytest.approx(50.0)
    trace.counters = {"bssm_sweep_sir": 4}
    assert reader(trace) is None


def test_event_work_sets_the_gillespie_bounds():
    t_none, by_none = k4.gillespie_day(4096, 128, 0)
    t_some, by_some = k4.gillespie_day(4096, 128, 5e6)
    assert by_none == "bytes" and by_some == "operations"
    assert t_some > t_none
    assert peaks.bound(0.0, (1, (128, 0, 0)))[0] == pytest.approx(
        1 / peaks.SM_CLOCKS_S)
