"""The benchmark's stochastic-volatility configuration (``sv_ksc_945``,
Kim, Shephard & Chib's model over 945 days) against its plain reference.

The program's filter is the one ``benchmark/programs/sv.py`` builds: the
user's callbacks through the public ``build_sweep_pf_impl``. On the CPU
the op runs them as the plain sweep; on the card as the functor generated
from their trace (K1), held here bit for bit to the plain sweep. The
reference (``benchmark/reference/sv.py``) imports nothing of the port and
runs through ``benchmark/reference/smc.py::sweep_filter``. The CPU
comparisons are bitwise: the reference restates each op in the same
order on the same device.
"""

import numpy as np
import pytest
import torch

from benchmark.lib.spec import load_cell
from benchmark.reference import lowbias, smc
from bayesssm_tpu_torch.models.stochastic_volatility import simulate_sv
from bayesssm_tpu_torch.ops import _build, sweep_codegen
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys
from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

CELL = load_cell("sv.sweep")
CFG = CELL.config
PROGRAM = CELL.program()
REF = CELL.reference()
Y = REF.simulate(CFG)


def _words(c, seed, dev="cpu"):
    return lowbias.chain_words(seed, c, dev)


def _theta(c, seed, dev="cpu"):
    """Seeded parameters inside the priors' support (phi in (0, 1),
    sigma > 0), around the configuration's."""
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.85, 0.995, c), rng.uniform(0.05, 0.4, c),
                      rng.normal(CFG["theta"]["mu"], 0.5, c)], axis=1)
    return torch.as_tensor(theta.astype(np.float32), device=dev)


def _op():
    return build_sweep_op(1, PROGRAM.sv_init, PROGRAM.sv_transition,
                          PROGRAM.sv_log_weight, 3)


def _reference_ll(words, theta, n, lanes):
    model = REF.Model(CFG)
    return smc.sweep_filter(model, words,
                            model.sweep_obs(Y, theta.device, torch.float32),
                            theta, n, lanes)


def test_the_reference_dataset_is_simulate_sv():
    th = CFG["theta"]
    assert len(Y) == CFG["t_max"] == 945
    np.testing.assert_array_equal(
        Y, simulate_sv(CFG["data_seed"], CFG["t_max"], th["phi"],
                       th["sigma"], th["mu"])[1])


@pytest.mark.parametrize("alive", [100, 128])
def test_the_programs_filter_is_the_reference_bit_for_bit(alive):
    pf, _ = PROGRAM.build(CFG, "sweep", Y, alive, 128)
    c = 8
    words, theta = _words(c, 21 + alive), _theta(c, alive)
    n = torch.full((c,), float(alive))
    want, est = pf(words, theta, n)
    got = _reference_ll(words, theta, n, 128)
    assert est.shape == (c, len(Y) + 1)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("key", ["init", "transition", "log_weight"])
def test_the_traced_ir_is_the_reference_callbacks(key):
    traced = _op().trace().fns[key]
    c, n = 6, 128
    rng = np.random.default_rng(5)
    th = tuple(t[:, None].expand(c, n) for t in _theta(c, 9).unbind(1))
    cols = (torch.as_tensor(rng.normal(-0.9, 1.5, (c, n)).astype(np.float32)),)
    y_t = torch.tensor(float(np.float32(Y[17])))
    keys = lane_keys(_words(c, 4), n)
    port_rng = SweepRng(keys)
    ref_rng = smc.SweepRng(keys, torch.float32)
    model = REF.Model(CFG)
    if key == "init":
        got = sweep_codegen.evaluate(traced, rng=port_rng, theta=th)
        want = model.sweep_init(ref_rng, th)
    elif key == "transition":
        got = sweep_codegen.evaluate(traced, rng=port_rng, cols=cols,
                                     theta=th, t=3)
        want = model.sweep_transition(ref_rng, cols, th, 3, None)
    else:
        got = (sweep_codegen.evaluate(traced, cols=cols, theta=th, y_t=y_t),)
        want = (model.sweep_log_weight(cols, th, y_t),)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(port_rng.counter(), ref_rng.ctr)


def test_control_in_bfloat16_breaks_a_limit():
    cell = load_cell("sv.sweep")
    cell.workload.update(chains=8, particles=100, lanes=128,
                         steps_per_call=2, trace_calls=1)
    driver = cell.driver()
    loop = driver.setup(cell, 2**40 + 3, torch.device("cpu"))
    driver.window(loop, 0.0, False)
    driver.release(loop)
    sound, _ = driver.check(loop)
    control = driver.control(loop, torch.bfloat16)
    limits = cell.workload["limits"]
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(not control[k] <= limits[k] for k in limits)


def test_a_cpu_sample_chains_call_spans_prepare_once_a_filter():
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

    pf, priors = PROGRAM.build(CFG, "sweep", Y[:20], 100, 128)
    names = ["phi", "sigma", "mu"]
    state = init_chain_state(
        np.float32([CFG["theta"][q] for q in names]),
        np.tile(np.diag(CFG["proposal_sd"]).astype(np.float32), (4, 1, 1)),
        100, 11, "cpu")
    timing.reset()
    sample_chains(pf, state, 4, 1, priors,
                  resolve_transforms(CFG["transform"], names))
    (call,) = timing.recent_calls()
    spans = {p: a["count"] for p, a in call["spans"].items()}
    for outer in ("sample_chains/filter", "sample_chains/mh_step/filter"):
        assert spans[f"{outer}/prepare"] == spans[outer]
    assert spans["sample_chains/filter"] == 1
    assert spans["sample_chains/mh_step/filter"] == 3
    # The plain sweep on CPU tensors launches and generates nothing.
    assert not any(p.endswith(("/launch", "/codegen")) for p in spans)
    assert "sweep.lane_days" not in call["counters"]
    timing.reset()


def test_generated_kernel_spans_codegen_once_per_op():
    timing.reset()
    ops = (_op(), _op())
    with timing.span("root"):
        first = ops[0].generated_kernel()
        assert ops[0].generated_kernel() is first
        second = ops[1].generated_kernel()
    (call,) = timing.recent_calls()
    assert call["spans"]["root/codegen"]["count"] == 2
    assert first.entry == second.entry and first.source == second.source
    assert "generated.build" not in call["counters"]      # nvcc runs later
    timing.reset()


# --- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k1g_is_the_plain_sweep_bit_for_bit_at_the_published_length(dev):
    c, lanes = 64, 1024
    op = _op()
    words, theta = _words(c, 77, dev), _theta(c, 78, dev)
    n = torch.linspace(50.0, 1024.0, c, device=dev).floor()
    n[0] = 1000.0
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    launched = _build.launches[_build.GENERATED]
    ll, est = op(words, y, theta, n, max_particles=lanes)
    assert _build.launches[_build.GENERATED] == launched + 1
    want_ll, want_est = op.sweep_reference(words, y, theta, n,
                                           max_particles=lanes)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, want_ll) and torch.equal(est, want_est)
    assert torch.equal(_reference_ll(words, theta, n, lanes), ll)


@pytest.mark.cuda
def test_the_counters_of_a_launch_and_of_a_functors_load(dev):
    # A functor of its own (an extra exact op in the log-weight), so that
    # this process has not loaded it yet.
    def log_weight(cols, theta, y_t):
        return PROGRAM.sv_log_weight(cols, theta, y_t) * 1.0

    op = build_sweep_op(1, PROGRAM.sv_init, PROGRAM.sv_transition,
                        log_weight, 3)
    c, lanes, t = 16, 1024, len(Y)
    words, theta = _words(c, 5, dev), _theta(c, 6, dev)
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    timing.reset()
    for _ in range(2):
        with timing.span("call"):
            op(words, y, theta, 1000.0, max_particles=lanes)
    torch.cuda.synchronize()
    first, second = (r["counters"] for r in timing.recent_calls())
    assert first["sweep.lane_days"] == second["sweep.lane_days"] \
        == c * lanes * t
    assert first.get("generated.build", 0) + first.get(
        "generated.load", 0) == 1
    assert "generated.build" not in second and "generated.load" not in second
    timing.reset()
