"""The port imports no JAX: the machine with the GPU has none."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bayesssm_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "torch_custom_sweep_kernel.py",
        ROOT / "examples" / "torch_many_chains_mesh.py",
        ROOT / "tests" / "_torch_dist.py",
        *sorted((ROOT / "scripts").glob("torch_*.py"))]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "bayesssm_tpu"), (path, name)


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["bayesssm_tpu"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        from bayesssm_tpu_torch.models.sir import (
            simulate_sir, sir_model, sir_sweep_pf_impl)
        from bayesssm_tpu_torch.pmmh.driver import (
            init_chain_state, sample_chains)
        from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
        _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=4)
        _, lp, tr = sir_model()
        names = list(lp)
        pf = sir_sweep_pf_impl(100, 10)(
            y, 128, names, None, None, "BPF", "SISAR", "stratified", False,
            max_particles=128)
        state = init_chain_state(
            [0.4, 0.25], np.tile(np.eye(2, dtype=np.float32) * 0.1,
                                 (4, 1, 1)), 128, 3, "cpu")
        out = sample_chains(pf, state, 3, 1, [lp[p] for p in names],
                            resolve_transforms(tr, names))
        assert out.samples.shape == (4, 2, 2)
        assert np.isfinite(out.samples).all()
        from bayesssm_tpu_torch import bootstrap_filter
        from bayesssm_tpu_torch.models.lgss import lgss_model
        from bayesssm_tpu_torch.ops import threefry
        fns, lp2, tr2 = lgss_model()
        res = bootstrap_filter(
            threefry.split(threefry.key(1)[None], 3)[0], np.zeros(4), 16,
            *fns, theta=dict(a=0.9, sigma_x=0.6, sigma_y=0.4))
        assert res.loglike.shape == (3,)
        assert np.isfinite(res.loglike.numpy()).all()
        import bayesssm_tpu_torch as bt
        keys = threefry.split(threefry.key(2)[None], 3)[0]
        apf = bt.auxiliary_filter(keys, np.zeros(4), 16, *fns, fns[2],
                                  theta=dict(a=0.9, sigma_x=0.6,
                                             sigma_y=0.4))
        rmpf = bt.resample_move_filter(
            keys, np.zeros(4), 16, *fns, lambda particles: particles,
            theta=dict(a=0.9, sigma_x=0.6, sigma_y=0.4))
        for r in (apf, rmpf):
            assert np.isfinite(r.loglike.numpy()).all()
        out = bt.pmmh("bootstrap_filter", np.zeros(4), 4, *fns, lp2,
                      {"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}, 1,
                      num_chains=2, param_transform=tr2, seed=1,
                      tune_control=bt.default_tune_control(
                          pilot_m=4, pilot_reps=2, pilot_n=20),
                      print_summary=False, device="cpu")
        assert out.theta_chain["a"].shape == (2, 3)
        assert np.isfinite(out.theta_chain["a"]).all()
        assert list(out.timings) == ["tuning", "compile", "sampling"]
        # The model zoo: the README model on both paths, SV, LGSS-mv with
        # its Kalman value, tau-leaping and its binomials.
        from bayesssm_tpu_torch.models.sinusoidal import (
            simulate_sinusoidal, sinusoidal_model, sinusoidal_sweep_pf_impl)
        from bayesssm_tpu_torch.models.stochastic_volatility import (
            simulate_sv, sv_model)
        from bayesssm_tpu_torch.models.lgss import (
            lgss_mv_model, simulate_lgss_mv)
        from bayesssm_tpu_torch.ops.lgss_sweep import (
            lgss_mv_bpf_sweep, lgss_sweep_pf_impl)
        from bayesssm_tpu_torch.utils.kalman import kalman_loglik_mv
        _, ys = simulate_sinusoidal(1405, 5)
        sfns, slp, str_ = sinusoidal_model()
        for pf_impl in (None, sinusoidal_sweep_pf_impl()):
            out = bt.pmmh("bootstrap_filter", ys, 3, *sfns, slp,
                          {"phi": 0.8, "sigma_x": 1.0, "sigma_y": 0.5}, 1,
                          num_chains=2, param_transform=str_, seed=1,
                          tune_control=bt.default_tune_control(
                              pilot_m=3, pilot_reps=2, pilot_n=20),
                          pf_impl=pf_impl, print_summary=False,
                          device="cpu")
            assert np.isfinite(out.theta_chain["phi"]).all()
        _, yv = simulate_sv(1405, 6)
        vfns, _, _ = sv_model()
        res = bt.bootstrap_filter(keys, yv, 16, *vfns,
                                  theta=dict(phi=0.9, sigma=0.3, mu=-1.0))
        assert np.isfinite(res.loglike.numpy()).all()
        _, ym = simulate_lgss_mv(3, 5)
        mfns, _, _ = lgss_mv_model()
        res = bt.bootstrap_filter(keys, ym, 16, *mfns,
                                  theta=dict(a=0.9, sigma_x=0.6,
                                             sigma_y=0.4))
        ll, _ = lgss_mv_bpf_sweep(keys, ym, 128, 0.9, 0.6, (0.4, 0.4))
        assert np.isfinite(ll.numpy()).all()
        assert np.isfinite(kalman_loglik_mv(ym, 0.9, (1.0, 0.5), 0.6,
                                            (0.4, 0.4)))
        assert callable(lgss_sweep_pf_impl())
        tfns, _, _ = bt.sir_model(100, 10, transition="tauleap", substeps=3)
        _, yt = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=3)
        res = bt.bootstrap_filter(keys, yt, 16, *tfns,
                                  theta=dict(lam=0.4, gamma=0.25))
        assert np.isfinite(res.loglike.numpy()).all()
        draws = threefry.binomial(keys, torch.full((3, 8), 50.0),
                                  torch.full((3, 8), 0.4))
        assert draws.shape == (3, 8)
        # User-written callbacks: traced into a generated functor, and the
        # example's pmmh() on the plain sweep.
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "ex", "examples/torch_custom_sweep_kernel.py")
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op
        op = build_sweep_op(1, ex.sv_init, ex.sv_transition,
                            ex.sv_log_weight, 3)
        assert "struct GenModel" in op.generated_kernel().source
        out = ex.main(m=4, device="cpu")
        assert np.isfinite(out.theta_chain["phi"]).all()
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
