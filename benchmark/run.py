"""Run one cell of the benchmark of ``bayesssm_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the package. A run sets up (builds
or loads the kernels, makes the cell's inputs, warms its shapes up),
measures for ``--seconds``, checks what the timed path produced against
the plain reference under ``benchmark/reference/``, and prints one JSON
line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` a stretch of the window runs under ``torch.profiler`` and
the metrics are the cell's per-layer metrics, read by
``benchmark/metrics/<metric>.py``. ``checks`` gives each number compared
with its limit; the same lines end standard error.

The cell, its configuration, its driver and its metrics are found by name
(``benchmark/lib/spec.py``). Without a CUDA device, or with fewer than the
cell's chips, the run exits non-zero and prints no result; so does a run
after which ``jax``, ``jaxlib``, ``flax`` or ``bayesssm_tpu`` is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "bayesssm_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not load,
    compared whole: ``bayesssm_tpu_torch`` is not ``bayesssm_tpu``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def finite(value):
    """A JSON-safe number: an infinite or NaN gap reads as 1e300."""
    return value if value == value and abs(value) != float("inf") else 1e300


def host_probe() -> float:
    """Seconds a fixed pure-Python loop takes: the host's speed at the
    time, printed beside the window (the cells wait on the host)."""
    t0 = time.perf_counter()
    total = 0
    for i in range(1_000_000):
        total += i
    return time.perf_counter() - t0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def _device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict."""
    import numpy as np

    driver = cell.driver()
    loop = driver.setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    probe = [host_probe()]
    win = driver.window(loop, seconds, trace)
    probe.append(host_probe())
    info = _device_info(device, cell.chips)
    driver.release(loop)
    numbers, work = driver.check(loop)
    limits = cell.workload["limits"]
    checks = {k: {"value": finite(numbers[k]), "limit": limits[k]}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    q = np.quantile(win["call_s"], [0, 0.25, 0.5, 0.75, 1]) if win[
        "call_s"] else []
    print(f"window: {win['calls']} calls, {win['window_s']:.6f} s, "
          f"call s min/q1/med/q3/max {np.round(q, 4).tolist()}, "
          + ", ".join(f"{k}={v!r}" for k, v in win["e2e"].items())
          + f"; setup_s={setup_s!r}; host probe ms before/after "
          f"{probe[0] * 1e3:.1f}/{probe[1] * 1e3:.1f}"
          + (f"; trace reduced in {win['trace'].reduce_s:.3f} s"
             if trace else "") + "; reference: "
          + ", ".join(f"{k}={v}" for k, v in numbers.items()
                      if k.startswith("_")), file=sys.stderr)
    values = dict(win["e2e"], setup_s=setup_s)
    result = dict(correct=correct, attempted=win["attempted"], failed=0)
    if trace:
        tr = win["trace"]
        tr.work.update(work)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        result.update(metrics=metrics, device=info,
                      breakdown={"device_ops": tr.top_ops(),
                                 "idle_gaps": tr.idle_gaps})
    else:
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end}, device=info)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    # Caches of the libraries the program may use, at fixed paths inside
    # the checkout (the kernels build into build/bayesssm_tpu_torch/).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from benchmark.lib.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
