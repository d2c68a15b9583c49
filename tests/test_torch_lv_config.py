"""The benchmark's Lotka-Volterra CLE configuration (``lv_cle_smfsb``: 15
two-species observations, 200 Euler steps before each) against its plain
reference.

The program's filter is the one ``benchmark/programs/lv.py`` builds: the
user's two-column callbacks through the public ``build_sweep_pf_impl``,
with the observation times in Euler steps, so that the sweep runs
``gaps[t]`` transitions before each weight stage. On the CPU the op runs
them as the plain sweep; on the card as the functor generated from their
trace inside K1's gap loop, held here bit for bit to the plain sweep. The
reference (``benchmark/reference/lv.py``) imports nothing of the port,
makes each day's Euler steps in its own transition and runs through
``benchmark/reference/smc.py::sweep_filter``. The CPU comparisons are
bitwise: the reference restates each op in the same order on the same
device.
"""

import collections

import numpy as np
import pytest
import torch

from benchmark.lib.spec import load_cell
from benchmark.reference import lowbias, smc
from bayesssm_tpu_torch.ops import _build, sweep_codegen
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys
from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

CELL = load_cell("lv.sweep")
CFG = CELL.config
PROGRAM = CELL.program()
REF = CELL.reference()
Y = REF.simulate(CFG)


def _words(c, seed, dev="cpu"):
    return lowbias.chain_words(seed, c, dev)


def _theta(c, seed, dev="cpu"):
    """Seeded rates inside the priors' support, around the
    configuration's."""
    rng = np.random.default_rng(seed)
    th = CFG["theta"]
    theta = np.stack([th[q] * np.exp(rng.normal(0.0, 0.2, c))
                      for q in PROGRAM.PARAMS], axis=1)
    return torch.as_tensor(theta.astype(np.float32), device=dev)


def _pf(gaps, y, alive=100, lanes=128):
    return PROGRAM.lv_pf_impl()(y, alive, list(PROGRAM.PARAMS), None,
                                np.cumsum(gaps), "BPF", "SISAR",
                                "stratified", False, max_particles=lanes)


def _reference_ll(words, theta, n, lanes, y, gaps=None):
    model = REF.Model(CFG, gaps)
    return smc.sweep_filter(model, words,
                            model.sweep_obs(y, theta.device, torch.float32),
                            theta, n, lanes)


def test_the_dataset_follows_the_published_schedule():
    assert Y.shape == (CFG["t_max"], 2) == (15, 2)
    assert np.isfinite(Y).all() and (Y > 0).all()
    np.testing.assert_array_equal(Y, REF.simulate(dict(CFG)))
    np.testing.assert_array_equal(PROGRAM.obs_times(CFG),
                                  200 * np.arange(1, 16))


@pytest.mark.parametrize("gaps", [(20, 20, 20), (3, 17, 9)])
def test_the_programs_filter_is_the_reference_bit_for_bit(gaps):
    c = 16
    words, theta = _words(c, 31 + gaps[0]), _theta(c, gaps[1])
    n = torch.full((c,), 100.0)
    got, est = _pf(gaps, Y[:3])(words, theta, n)
    want = _reference_ll(words, theta, n, 128, Y[:3], gaps)
    assert est.shape == (c, 4, 2)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _op():
    return build_sweep_op(2, PROGRAM.lv_init, PROGRAM.lv_transition,
                          PROGRAM.lv_log_weight, 3, num_obs_cols=2)


def _states(c, n):
    """Random ``[C, N]`` states around the data's range, a share of each
    column at exactly 0."""
    rng = np.random.default_rng(5)
    cols = rng.uniform(0.0, 400.0, (2, c, n)).astype(np.float32)
    cols[0, :, :16] = 0.0
    cols[1, :, 8:24] = 0.0
    return tuple(torch.as_tensor(x) for x in cols)


@pytest.mark.parametrize("key", ["init", "transition", "log_weight"])
def test_the_traced_ir_is_the_callbacks(key):
    traced = _op().trace().fns[key]
    c, n = 6, 128
    th = tuple(t[:, None].expand(c, n) for t in _theta(c, 9).unbind(1))
    cols = _states(c, n)
    y_t = tuple(torch.tensor(float(np.float32(v))) for v in Y[4])
    keys = lane_keys(_words(c, 4), n)
    port_rng, own_rng = SweepRng(keys), SweepRng(keys)
    ref_rng = smc.SweepRng(keys, torch.float32)
    model = REF.Model(CFG, gaps=(1,))
    if key == "init":
        got = sweep_codegen.evaluate(traced, rng=port_rng, theta=th)
        own = PROGRAM.lv_init(own_rng, th)
        want = model.sweep_init(ref_rng, th)
    elif key == "transition":
        got = sweep_codegen.evaluate(traced, rng=port_rng, cols=cols,
                                     theta=th, t=3)
        own = PROGRAM.lv_transition(own_rng, cols, th, 3)
        want = model.sweep_transition(ref_rng, cols, th, 0, None)
    else:
        got = (sweep_codegen.evaluate(traced, cols=cols, theta=th, y_t=y_t),)
        own = (PROGRAM.lv_log_weight(cols, th, y_t),)
        want = (model.sweep_log_weight(cols, th, y_t),)
    for a, b, r in zip(got, own, want):
        assert not torch.isnan(a).any() and torch.isfinite(a).all()
        assert torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(port_rng.counter(), own_rng.counter())
    assert torch.equal(port_rng.counter(), ref_rng.ctr)


def _ir_ops(fn):
    """The roofline's op classes of a traced callback's IR: a division by
    a number is emitted as a multiply."""
    kinds = collections.Counter()
    for node in fn.nodes:
        by_number = (node.op == "div"
                     and isinstance(node.args[1], sweep_codegen.Const))
        if node.op in ("add", "sub", "mul", "neg") or by_number:
            kinds["float"] += 1
        elif node.op not in ("col", "theta", "obs", "time"):
            kinds[node.op] += 1
    return dict(kinds)


def test_the_roofline_counts_the_traced_ir_and_follows_the_schedule():
    from benchmark.roofline import lv

    fns = _op().trace().fns
    assert _ir_ops(fns["init"]) == lv.INIT_OPS
    assert _ir_ops(fns["transition"]) == lv.TRANSITION_OPS
    assert _ir_ops(fns["log_weight"]) == lv.LOG_WEIGHT_OPS
    assert lv.obs_every() == CFG["obs_every"] == 200
    live, t, n = 4096 * 100, 15, 128
    base = lv.work(live, t, n)
    doubled = lv.work(live, t, n, steps=2 * CFG["obs_every"])
    assert base["transition"][0] == live * t * 200
    assert doubled["transition"][0] == 2 * base["transition"][0]
    assert doubled["transition"][1] == base["transition"][1]
    assert doubled["init"] == base["init"]
    assert doubled["stage"] == base["stage"]


# --- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k1g_gap_loop_is_the_plain_sweep_bit_for_bit_at_full_schedule(dev):
    c, lanes = 256, 128
    gaps = (CFG["obs_every"],) * CFG["t_max"]
    op = build_sweep_op(2, PROGRAM.lv_init, PROGRAM.lv_transition,
                        PROGRAM.lv_log_weight, 3, num_obs_cols=2,
                        obs_gaps=gaps)
    words, theta = _words(c, 77, dev), _theta(c, 78, dev)
    n = torch.linspace(50.0, 128.0, c, device=dev).floor()
    n[0] = 100.0
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    launched = _build.launches[_build.GENERATED]
    timing.reset()
    with timing.span("call"):
        ll, est = op(words, y, theta, n, max_particles=lanes)
    torch.cuda.synchronize()
    (record,) = timing.recent_calls()
    assert _build.launches[_build.GENERATED] == launched + 1
    assert record["counters"]["sweep.lane_transitions"] == c * lanes * 3000
    assert record["counters"]["sweep.lane_days"] == c * lanes * 15
    want_ll, want_est = op.sweep_reference(words, y, theta, n,
                                           max_particles=lanes)
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, want_ll) and torch.equal(est, want_est)
    assert torch.equal(_reference_ll(words, theta, n, lanes, Y), ll)
    timing.reset()


@pytest.mark.cuda
def test_lane_transitions_equal_lane_days_without_gaps(dev):
    sv = load_cell("sv.sweep").program()
    op = build_sweep_op(1, sv.sv_init, sv.sv_transition, sv.sv_log_weight, 3)
    c, lanes, t = 16, 128, 40
    words = _words(c, 5, dev)
    theta = torch.tensor([[0.95, 0.2, -0.9]] * c, device=dev)
    y = torch.linspace(-1.0, 1.0, t, device=dev)
    timing.reset()
    with timing.span("call"):
        op(words, y, theta, 100.0, max_particles=lanes)
    torch.cuda.synchronize()
    (record,) = timing.recent_calls()
    counters = record["counters"]
    assert counters["sweep.lane_transitions"] == counters["sweep.lane_days"] \
        == c * lanes * t
    timing.reset()
