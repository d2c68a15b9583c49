"""Find a cell and everything it names, by name, in files of their own.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
A cell ``<cell>`` has ``workloads/<cell>.json`` (its configuration, driver,
filter path, sizes and limits); its configuration ``<config>`` has
``configs/<config>.json`` (the model family, its published settings,
``source``, ``reduced``, ``assumed``), and the family ``<model>`` has
``programs/<model>.py`` (how to build the system under test's filter or
call), ``reference/<model>.py`` (its plain reference and data) and
``roofline/<model>.py`` (the least time its filter work needs). A driver
``<driver>`` is ``drivers/<driver>.py`` and a per-layer metric ``<metric>``
is read by ``metrics/<metric>.py``. Adding any of them is adding files
and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import re
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: pathlib.Path

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of the benchmark's folder, loaded from its
        file."""
        return load_file(self.bench_dir / kind / f"{name}.py",
                         f"benchmark_{kind}_{name}")

    def driver(self):
        return self.module("drivers", self.workload["driver"])

    def program(self):
        return self.module("programs", self.config["model"])

    def reference(self):
        return self.module("reference", self.config["model"])

    def reader(self, metric: str):
        """The ``read(trace)`` function of a per-layer metric."""
        return self.module("metrics", metric).read


def load_file(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    modname = re.sub(r"[^0-9A-Za-z_]", "_", f"{name}_{tag}")
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is reported by the cells it lists; an
    end-to-end metric without it by every cell, a per-layer one by every
    cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (``root`` defaults to
    the checkout that holds this folder)."""
    bench_dir = BENCH_DIR if root is None else pathlib.Path(root) / "benchmark"
    root = bench_dir.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    config_entry = next(c for c in spec["configs"]
                        if c["name"] == entry["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    workload = json.loads((bench_dir / "workloads" / f"{name}.json")
                          .read_text())
    if workload["config"] != entry["config"]:
        raise ValueError(f"workloads/{name}.json names configuration "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name, int(entry["chips"]), config, workload, e2e, per_layer,
                bench_dir)
