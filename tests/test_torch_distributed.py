"""Two processes, one gloo group: the mirror of ``tests/test_distributed.py``
on the port, and the CPU run of ``examples/torch_many_chains_mesh.py``.

The JAX tests start two ``jax.distributed`` processes of two virtual
devices each; the port runs one device a process, so its two ranks
build the (1 x 2) and (2 x 1) meshes. Both ranks join through
``parallel.initialize`` with a ``file://`` store (``tests/_torch_dist.py``)
and run the JAX worker's steps: a cross-process collective, one
particle-sharded filter, ``pmmh()`` on the chains mesh and on the
particle mesh (every rank returns the same full output), and checkpoint
/ resume with both ranks writing the same snapshot paths.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as td

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ck_dir = tmp_path_factory.mktemp("ck")
    return td.run_session(
        2, [("smoke", td.dist_smoke, dict(ck_dir=str(ck_dir)))],
        tmp_path_factory.mktemp("ranks"))["smoke"]


def assert_same(a, b):
    for p in a["theta"]:
        np.testing.assert_array_equal(a["theta"][p], b["theta"][p])
    np.testing.assert_array_equal(a["target_n"], b["target_n"])
    np.testing.assert_array_equal(a["acceptance"], b["acceptance"])


def test_two_process_distributed_smoke(ranks):
    r0, r1 = ranks
    for out in ranks:
        assert out["total"] == 28.0
        assert out["ll"].shape == (2,) and np.isfinite(out["ll"]).all()
        chains = np.stack([out["digest"]["theta"][p]
                           for p in sorted(out["digest"]["theta"])], -1)
        assert chains.shape == (4, 10, 3) and np.isfinite(chains).all()
        chains_ps = np.stack([out["ps_digest"]["theta"][p]
                              for p in sorted(out["ps_digest"]["theta"])],
                             -1)
        assert chains_ps.shape == (2, 6, 3)
        assert np.isfinite(chains_ps).all()
        # "PMMH CK-RESUME BIT-MATCH"
        assert_same(out["plain"], out["resumed"])
    np.testing.assert_array_equal(r0["ll"], r1["ll"])
    for key in ("digest", "ps_digest"):
        assert_same(r0[key], r1[key])


def test_two_process_pmmh_matches_single_process(ranks):
    """The chains mesh over two processes against one process without a
    mesh: the same chains, bit for bit (the JAX test compares digests
    printed to 6 decimals)."""
    single = td.dist_config_pmmh(None)
    for out in ranks:
        assert_same(out["digest"], single)


def test_many_chains_mesh_example_on_two_cpu_ranks():
    """``examples/torch_many_chains_mesh.py`` spawns two gloo ranks and runs
    its chains-mesh ``pmmh()`` and particle-sharded filter."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_many_chains_mesh.py"),
         "--device", "cpu", "--ranks", "2", "--m", "20", "--particles",
         "256"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PMMH Results Summary" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("sharded filter loglikes:")]
    assert len(line) == 1, proc.stdout
    values = np.array(line[0].split("[")[1].split("]")[0].split(), float)
    assert values.shape == (4,) and np.isfinite(values).all()
