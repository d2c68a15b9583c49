"""The harness: cells, configurations and metrics found by name in files
of their own, the result line's keys, the run without a card, and
``correct`` coming out false with the timed path broken underneath."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import CELLS, PMMH_CELLS, ROOT, tiny_cell

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _digest(tree):
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(tree.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    from benchmark.lib.spec import load_cell

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "sir_500_70.json").read_text())
    cfg.update(n_total=1000, init_infected=50)
    (bench / "configs" / "sir_1000_50.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "sir.sweep.json").read_text())
    wl.update(config="sir_1000_50", particles=256, lanes=256)
    (bench / "workloads" / "sir1000.sweep.json").write_text(json.dumps(wl))
    (bench / "metrics" / "filter_calls.probe.py").write_text(
        "def read(t):\n    return float(len(t.spans.get('filter', ())))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="sir_1000_50",
                                file="benchmark/configs/sir_1000_50.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="sir1000.sweep",
                                  config="sir_1000_50"))
    spec["per_layer"].append(dict(spec["per_layer"][0],
                                  name="filter_calls.probe",
                                  workloads=["sir1000.sweep"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("sir1000.sweep", tmp_path)
    assert cell.config["n_total"] == 1000 and cell.workload["lanes"] == 256
    assert "filter_calls.probe" in [m["name"] for m in cell.per_layer]
    assert cell.driver().__file__.startswith(str(bench))
    from benchmark.lib.tracing import Trace

    assert cell.reader("filter_calls.probe")(
        Trace(spans={"filter": [(0, 1)] * 3})) == 3.0
    assert "filter_calls.probe" not in [
        m["name"] for m in load_cell("sir.sweep", tmp_path).per_layer]
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name,trace", [("sir.sweep", False),
                                        ("sir.sweep", True),
                                        ("sir.pmmh", False)])
def test_the_result_line_holds_the_contract_keys(name, trace):
    from benchmark import run

    cell = tiny_cell(name)
    result = run.run_cell(cell, 2**33 + 5, 0.5, trace, CPU,
                          time.perf_counter())
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True
    json.dumps(result, allow_nan=False)
    assert set(result["checks"]) == set(cell.workload["limits"])
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "mh_host_ms_per_step" in result["metrics"]
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in cell.end_to_end}
        assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sir.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def _state_unchanged(monkeypatch):
    """Every MH step returns the chain's state unchanged."""
    import dataclasses

    from bayesssm_tpu_torch.pmmh import driver

    real = driver.sample_chains

    def broken(pf, state, m, burn_in, *args, **kwargs):
        res = real(pf, state, m, burn_in, *args, **kwargs)
        res.samples[:] = state.theta.cpu().numpy()[:, None]
        res.state = dataclasses.replace(res.state, theta=state.theta)
        return res

    monkeypatch.setattr(driver, "sample_chains", broken)


def _wrap_filter(monkeypatch, cell, alter):
    program = cell.program()
    real = program.build

    def build(*args, **kwargs):
        pf, priors = real(*args, **kwargs)

        def broken(seed_words, theta, n):
            ll, est = pf(seed_words, theta, n)
            return alter(ll.clone()), est

        return broken, priors

    monkeypatch.setattr(program, "build", build)


def _wrap_pmmh_filter(monkeypatch, cell, alter):
    program = cell.program()
    real = program.pmmh_model

    def pmmh_model(*args, **kwargs):
        fns, priors, factory = real(*args, **kwargs)

        def broken_factory(*f_args, **f_kwargs):
            pf = factory(*f_args, **f_kwargs)

            def broken(seed_words, theta, *n):
                ll, est = pf(seed_words, theta, *n)
                return alter(ll.clone()), est

            return broken

        return fns, priors, broken_factory

    monkeypatch.setattr(program, "pmmh_model", pmmh_model)


def _half_batch(ll):
    """Half of the chains left out, the mean of the rest in their place."""
    h = ll.shape[0] // 2
    ll[h:] = ll[:h].mean()
    return ll


def _one_answer(ll):
    """One chain's log-likelihood altered where it is produced."""
    ll[1] += 0.5
    return ll


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "one_answer"])
@pytest.mark.parametrize("name", CELLS + PMMH_CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            card_paths):
    from benchmark import run

    cell = tiny_cell(name)
    wrap = _wrap_pmmh_filter if name in PMMH_CELLS else _wrap_filter
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    else:
        wrap(monkeypatch, cell, {"half_batch": _half_batch,
                                 "one_answer": _one_answer}[fault])
    result = run.run_cell(cell, 77, 0.5, False, CPU, time.perf_counter())
    assert result["correct"] is False
