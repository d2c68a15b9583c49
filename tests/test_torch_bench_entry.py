"""``bench_torch.py``, the port of ``bench.py``, on the CPU: its command
line, the record it returns and prints, and its refusal to run without a
card unless ``--device cpu`` is given.

Widths are cut (8 chains, 16 engine particles; the sweep needs 128 lanes)
and the repetitions too; the card runs the full widths
(``chip_smoke.py`` phase 28).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--quick", "--device", "cpu", "--chains", "8", "--steps", "1",
         "--calls", "1", "--reps", "2", "--baseline-steps", "1"]
CASES = ([(c, t) for c in ("bpf", "apf", "rmpf")
          for t in bench_torch.TRANSITIONS]
         + [("sinusoidal", "sir_sweep"), ("pmmh", "sir_sweep"),
            ("pmmh", "gillespie_pallas")])
SUFFIX = {"bpf": "sir", "apf": "sir_apf", "rmpf": "sir_rmpf",
          "sinusoidal": "sinusoidal", "pmmh": "sir_pmmh_e2e"}


def _check(rec, config, chains=8):
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == (f"cuda_pmmh_samples_per_sec_{chains}chains_"
                             f"{SUFFIX[config]}")
    assert rec["unit"] == "samples/s"
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert np.isfinite(rec["vs_baseline"]) and rec["vs_baseline"] > 0


@pytest.mark.parametrize("config,transition", CASES)
def test_every_config_and_transition_runs(config, transition, monkeypatch,
                                          capsys):
    # --config pmmh tunes with bench.py's pilot (200 steps, 20 repetitions)
    # four times; the CPU run takes a short one, and few particles.
    monkeypatch.setattr(bench_torch, "PMMH_PILOT",
                        dict(pilot_m=4, pilot_burn_in=1, pilot_reps=2,
                             pilot_target_var=100.0))
    particles = "128" if transition == "sir_sweep" or (
        config == "sinusoidal") else "16"
    rec = bench_torch.main(SMALL + ["--config", config, "--transition",
                                    transition, "--particles", particles])
    _check(rec, config)
    err = capsys.readouterr().err
    assert "baseline:" in err
    assert ("pmmh e2e timings" if config == "pmmh" else "reps (samples/s)"
            ) in err


def test_quick_keeps_bench_py_cuts_unless_given():
    quick = bench_torch.parse_args(["--quick"])
    assert (quick.chains, quick.steps, quick.calls, quick.reps, quick.m,
            quick.baseline_steps, quick.baseline_reps) == (256, 2, 2, 2, 8,
                                                           2, 1)
    full = bench_torch.parse_args([])
    assert (full.chains, full.particles, full.steps, full.calls, full.reps,
            full.m, full.baseline_steps, full.baseline_reps, full.config,
            full.transition, full.device) == (
        4096, 128, 64, 2, 5, 512, 20, 3, "bpf", "sir_sweep", "cuda")
    assert bench_torch.parse_args(["--quick", "--chains", "8"]).chains == 8


def test_no_card_without_device_cpu_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--quick"])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    # The script itself: no card visible, no JSON line, a non-zero code.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_script_prints_the_record_last():
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", *SMALL, "--config", "sinusoidal"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    _check(json.loads(proc.stdout.strip().splitlines()[-1]), "sinusoidal")
