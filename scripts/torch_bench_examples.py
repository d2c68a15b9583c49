"""Time the port's bench entry and its examples at their own settings on
one CUDA card, with the kernels' launches per run.

Runs ``bench_torch.main`` for ``bench.py``'s default and ``--transition
gillespie_pallas`` at full width and ``--quick`` for the other
configurations, then the three examples (``examples/torch_*.py``: the
README call with ``--fused``, the SIR vignette, stochastic volatility)
with their own m and pilot, uncut. ``chip_smoke.py`` phases 28-29 run
the same with the cuts its time limit forces; this script measures what
those cuts save.

Run from the repo root: ``python3 scripts/torch_bench_examples.py``.
"""

import importlib.util
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import bench_torch  # noqa: E402

RUNS = ([], ["--transition", "gillespie_pallas"],
        ["--quick", "--config", "apf"], ["--quick", "--config", "rmpf"],
        ["--quick", "--config", "sinusoidal"],
        ["--quick", "--config", "pmmh"],
        ["--quick", "--transition", "tauleap"])
EXAMPLES = (("torch_sinusoidal_readme", dict(fused=True)),
            ("torch_stochastic_sir", {}),
            ("torch_stochastic_volatility", {}))


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bench_examples: needs a CUDA device", file=sys.stderr)
        return 1
    from bayesssm_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, flush=True)
    _build.load_library()
    for argv in RUNS:
        _build.reset_launches()
        t0 = time.perf_counter()
        rec = bench_torch.main(argv)
        print("BENCH", argv, rec, f"s={time.perf_counter() - t0:.2f}",
              {k: v for k, v in _build.launches.items() if v}, flush=True)
    for name, kw in EXAMPLES:
        mod = load(name)
        _build.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = mod.main(device="cuda", **kw)
        summ = out.summary()
        print("EXAMPLE", name, f"s={time.perf_counter() - t0:.2f}",
              out.timings, "target_n", out.target_n.tolist(), "acceptance",
              out.acceptance_rate.tolist(),
              {q: (summ[q]["mean"], summ[q]["sd"], summ[q]["ESS"])
               for q in summ},
              {k: v for k, v in _build.launches.items() if v}, flush=True)
        if hasattr(mod, "parity"):
            print("PARITY", mod.parity(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
