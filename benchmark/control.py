"""Readings that set a cell's limits: the program's numbers and the
control's, seed by seed, in one process.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--dtype bfloat16]

For each seed: the cell's set-up, a short window at its own load, the
comparison of the checked call with the reference (the program's
reading), then the same call's outputs as the reference computes them in
``--dtype``, the precision below the configuration's, put in the
program's place (the control's reading). Prints one JSON line a seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, seconds: float, dtype, device) -> dict:
    driver = cell.driver()
    loop = driver.setup(cell, seed, device)
    driver.window(loop, seconds, False)
    driver.release(loop)
    t0 = time.perf_counter()
    program, _ = driver.check(loop)
    t1 = time.perf_counter()
    control = driver.control(loop, dtype)
    return dict(seed=seed, program=program, control=control,
                reference_s=t1 - t0, control_s=time.perf_counter() - t1)


def main(argv=None) -> int:
    import torch

    from benchmark.lib.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, dtype,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
