"""What a run loads: nothing of JAX or of the JAX package (top-level names
compared whole), and a reference that loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from conftest import CELLS, PMMH_CELLS, ROOT

_RUN_IMPORTS = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import run
from benchmark.lib.spec import load_cell
for name in {CELLS + PMMH_CELLS!r}:
    cell = load_cell(name)
    cell.driver(); cell.reference()
    if name in {PMMH_CELLS!r}:
        cell.program().pmmh_model(cell.config, cell.workload["filter"])
    else:
        cell.program().build(cell.config, cell.workload["filter"],
                             cell.reference().simulate(cell.config), 100,
                             128)
    for m in cell.per_layer:
        cell.reader(m["name"])
print(",".join(run.loaded_forbidden()) or "none")
print("bayesssm_tpu_torch" in sys.modules)
"""

_REFERENCE_IMPORTS = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.check, benchmark.reference.sir
import benchmark.reference.sinusoidal, benchmark.reference.pmmh
import benchmark.roofline.step, benchmark.roofline.sir
import benchmark.roofline.sinusoidal
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"bayesssm_tpu_torch", "bayesssm_tpu", "jax"}}))
"""


def _run(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout.split()


def test_a_run_loads_no_jax_and_no_jax_package():
    forbidden, program_loaded = _run(_RUN_IMPORTS)
    assert forbidden == "none"
    assert program_loaded == "True"


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    added = ("bayesssm_tpu_torch_extra", "jaxlib.xla")
    try:
        for name in added:
            sys.modules[name] = sys
        assert run.loaded_forbidden() == ["jaxlib"]
    finally:
        for name in added:
            del sys.modules[name]


def test_the_reference_loads_nothing_of_the_program():
    assert _run(_REFERENCE_IMPORTS) == ["[]"]
