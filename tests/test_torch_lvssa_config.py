"""The benchmark's Lotka-Volterra configuration under exact Gillespie
simulation (``lv_ssa_smfsb``: 15 two-species observations 2 time units
apart) against its plain reference, and the loop primitive its callbacks
run, ``rng.event_loop``.

The program's filter is the one ``benchmark/programs/lvssa.py`` builds:
the user's callbacks, whose start and transition run their own event
loops through ``rng.event_loop``, given to the public
``build_sweep_pf_impl``. On the CPU the op runs them as the plain sweep,
which runs each loop over ``[C, N]`` masked; on the card as the functor
generated from their trace, each lane looping on its own inside K1, held
here bit for bit to the plain sweep. The reference
(``benchmark/reference/lvssa.py``) imports nothing of the port and runs
through ``benchmark/reference/smc.py::sweep_filter``. The CPU comparisons
are bitwise: the reference restates each op in the same order on the same
device.
"""

import collections

import numpy as np
import pytest
import torch

from benchmark.lib.spec import load_cell
from benchmark.reference import lowbias, smc
from bayesssm_tpu_torch.ops import _build, sweep_codegen
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys, uniform_blocks
from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

CELL = load_cell("lvssa.sweep")
CFG = CELL.config
PROGRAM = CELL.program()
REF = CELL.reference()
Y = REF.simulate(CFG)
LOOP_COUNTERS = ("sweep.loop_iters", "sweep.loop_slots")


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


def _pf(y, alive=100, lanes=128):
    return PROGRAM.lvssa_pf_impl()(y, alive, list(PROGRAM.PARAMS), None,
                                   None, "BPF", "SISAR", "stratified", False,
                                   max_particles=lanes)


def _op():
    return build_sweep_op(2, PROGRAM.lvssa_init, PROGRAM.lvssa_transition,
                          PROGRAM.lv_log_weight, 3, num_obs_cols=2)


def _recorded(fn):
    """``(fn(), the counters of the root call it ran in)``."""
    timing.reset()
    with timing.span("call"):
        out = fn()
    (record,) = timing.recent_calls()
    timing.reset()
    return out, record["counters"]


def test_the_dataset_follows_the_published_schedule():
    assert Y.shape == (CFG["t_max"], 2) == (15, 2)
    assert np.isfinite(Y).all() and (Y > 0).all()
    np.testing.assert_array_equal(Y, REF.simulate(dict(CFG)))
    assert (CFG["obs_interval"], CFG["max_iters"]) == (2.0, 100_000)
    assert set(CFG["assumed"]) == set(CFG["assumed_why"])


@pytest.mark.parametrize("seed", [3, 8])
def test_the_programs_filter_is_the_reference_bit_for_bit(seed):
    c = 16
    words, theta = _words(c, 31 + seed), _theta(c, seed)
    n = torch.full((c,), 100.0)
    (got, est), counters = _recorded(lambda: _pf(Y[:3])(words, theta, n))
    model = REF.Model(CFG)
    tally = smc.Tally()
    want = smc.sweep_filter(model, words,
                            model.sweep_obs(Y[:3], "cpu", torch.float32),
                            theta, n, 128, tally=tally)
    assert est.shape == (c, 4, 2)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # The lanes' own iterations, the start's arrivals included.
    assert counters["sweep.loop_iters"] == tally.fired > 0
    assert tally.chain_days == 3 * c
    assert counters["sweep.loop_iters"] < counters["sweep.loop_slots"]
    assert 0 < model.most_iters < CFG["max_iters"]


# --- the loop primitive against a hand-written plain loop -------------------


def _own_loop(keys, ctr, limit, step, max_iters):
    """``SweepRng.event_loop``'s contract written out chain by chain and
    lane by lane: the lane adds ``step`` times its uniform to ``s`` (and
    counts in ``k``) while ``s < limit``, at most ``max_iters`` times, at
    counters ``ctr + k``. Returns ``(s, k, ctr)``."""
    c, n = keys.shape
    s = torch.zeros((c, n))
    k = torch.zeros((c, n))
    ran = torch.zeros((c, 1), dtype=torch.int64)
    for ci in range(c):
        for lane in range(n):
            it = 0
            while it < max_iters and s[ci, lane] < limit[ci, lane]:
                u = uniform_blocks(keys[ci:ci + 1, lane:lane + 1],
                                   ctr[ci:ci + 1] + it, 1)[0, 0, 0]
                s[ci, lane] = s[ci, lane] + step * u
                k[ci, lane] += 1.0
                it += 1
            ran[ci, 0] = max(ran[ci, 0], it)
    return s, k, ctr + ran


def _limits(case, c, n):
    rng = np.random.default_rng(2)
    limit = rng.uniform(0.5, 4.0, (c, n)).astype(np.float32)
    if case == "false_at_start":
        limit[:] = 0.0
    elif case == "chain_done_early":
        limit[0] = 0.0            # every lane of chain 0 stops at once
        limit[1] = 0.05           # chain 1's after one iteration
    return torch.as_tensor(limit)


LOOP_CASES = {"false_at_start": 1000, "cap_binds": 3,
              "lanes_stop_apart": 1000, "chain_done_early": 1000}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_the_loop_primitive_is_the_plain_loop(case):
    c, n, step = 4, 8, 0.5
    max_iters = LOOP_CASES[case]
    keys = lane_keys(_words(c, 12), n)
    limit = _limits(case, c, n)
    ctr0 = torch.tensor([[5], [0], [9], [2]])

    def callback(rng, cols):
        def running(carry):
            return carry[0] < cols[1]

        def body(u, carry):
            s, k = carry
            return s + step * u[0], k + 1.0

        zero = torch.zeros_like(cols[0])
        return rng.event_loop(running, body, (zero, zero), draws=1,
                              max_iters=max_iters)

    cols = (torch.zeros((c, n)), limit)
    rng = SweepRng(keys, ctr0.clone())
    (s, k), counters = _recorded(lambda: callback(rng, cols))
    want_s, want_k, want_ctr = _own_loop(keys, ctr0, limit, step, max_iters)
    assert torch.equal(s, want_s) and torch.equal(k, want_k)
    assert torch.equal(rng.counter(), want_ctr)
    ran = want_ctr - ctr0
    assert counters.get("sweep.loop_iters", 0) == int(want_k.sum())
    assert counters.get("sweep.loop_slots", 0) == int(ran.sum()) * n
    if case == "false_at_start":
        assert torch.equal(rng.counter(), ctr0) and not k.any()
    elif case == "cap_binds":
        assert int(ran.max()) == max_iters and bool((s < limit).any())
    elif case == "lanes_stop_apart":
        assert len(set(k[0].tolist())) > 1
    else:
        assert int(ran[0]) == 0 and int(ran[1]) == 1 and int(ran[2]) > 1
    # The traced callback, run by the evaluator, moves the same way.
    traced = sweep_codegen.trace_fn(
        "probe", lambda rng, cols: callback(rng, cols),
        ("rng", ("cols", 2)), n_out=2)
    ev_rng = SweepRng(keys, ctr0.clone())
    got = sweep_codegen.evaluate(traced, rng=ev_rng, cols=cols)
    assert torch.equal(got[0], s) and torch.equal(got[1], k)
    assert torch.equal(ev_rng.counter(), rng.counter())


def test_a_loop_draws_at_its_counters_and_masks_stopped_lanes():
    """Two draws an iteration at ``ctr + 2k``; a lane that stops keeps its
    carry while the chain runs on."""
    c, n = 2, 4
    keys = lane_keys(_words(c, 5), n)
    rng = SweepRng(keys)
    stop = torch.tensor([[1.0, 3.0, 2.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    a, b, k = rng.event_loop(
        lambda carry: carry[2] < stop,
        lambda u, carry: (u[0], u[1], carry[2] + 1.0),
        (torch.zeros(c, n),) * 3, draws=2, max_iters=50)
    assert torch.equal(k, stop)
    u = uniform_blocks(keys, torch.zeros((c, 1), dtype=torch.int64), 6)
    last = (stop - 1.0).long()   # the iteration a lane stopped after
    assert torch.equal(a, torch.gather(u[0::2].permute(1, 2, 0), 2,
                                       last[..., None])[..., 0])
    assert torch.equal(b, torch.gather(u[1::2].permute(1, 2, 0), 2,
                                       last[..., None])[..., 0])
    assert torch.equal(rng.counter(), torch.tensor([[6], [4]]))


# --- the tracer -------------------------------------------------------------


def _states(c, n):
    """Random ``[C, N]`` counts around the data's range, some lanes with
    prey, predators or both extinct."""
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 400, (2, c, n)).astype(np.float32)
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
    model = REF.Model(CFG)
    if key == "init":
        got = sweep_codegen.evaluate(traced, rng=port_rng, theta=th)
        own = PROGRAM.lvssa_init(own_rng, th)
        want = model.sweep_init(ref_rng, th)
    elif key == "transition":
        got = sweep_codegen.evaluate(traced, rng=port_rng, cols=cols,
                                     theta=th, t=3)
        own = PROGRAM.lvssa_transition(own_rng, cols, th, 3)
        want = model.sweep_transition(ref_rng, cols, th, 3, None)
        # Extinct lanes run no event; both species extinct stay so.
        dead = (cols[0] == 0.0) & (cols[1] == 0.0)
        assert dead.any() and (got[0][dead] == 0.0).all()
        assert (got[1][dead] == 0.0).all()
        assert not torch.equal(got[0], cols[0])
    else:
        got = (sweep_codegen.evaluate(traced, cols=cols, theta=th, y_t=y_t),)
        own = (PROGRAM.lv_log_weight(cols, th, y_t),)
        want = (model.sweep_log_weight(cols, th, y_t),)
    for a, b, r in zip(got, own, want):
        assert not torch.isnan(a).any() and torch.isfinite(a).all()
        assert torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(port_rng.counter(), own_rng.counter())
    assert torch.equal(port_rng.counter(), ref_rng.ctr)


def _in_loop_draw(rng, cols, theta, t):
    def body(u, carry):
        return (carry[0] + rng.uniform(),)

    return rng.event_loop(lambda carry: carry[0] < 1.0, body, (cols[0],),
                          draws=1, max_iters=4)


def _nested(rng, cols, theta, t):
    def body(u, carry):
        inner = rng.event_loop(lambda c: c[0] < 1.0, lambda v, c: c,
                               carry, draws=1, max_iters=2)
        return inner

    return rng.event_loop(lambda carry: carry[0] < 1.0, body, (cols[0],),
                          draws=1, max_iters=4)


def _float_condition(rng, cols, theta, t):
    return rng.event_loop(lambda carry: carry[0] * 2.0,
                          lambda u, carry: carry, (cols[0],), draws=1,
                          max_iters=4)


@pytest.mark.parametrize("transition,cause", [
    (_in_loop_draw, "inside rng.event_loop"),
    (_nested, "nested `rng.event_loop`"),
    (_float_condition, "not a comparison"),
])
def test_the_tracer_names_what_a_loop_may_not_do(transition, cause):
    op = build_sweep_op(1, lambda rng, th: (th[0],), transition,
                        lambda cols, th, y: cols[0], 1)
    with pytest.raises(ValueError, match=cause):
        op.trace()
    if transition is not _float_condition:
        # The plain sweep refuses the same callbacks.
        with pytest.raises(ValueError, match="event_loop"):
            transition(SweepRng(lane_keys(_words(1, 0), 4)),
                       (torch.zeros(1, 4),), (torch.zeros(1, 4),), 0)


def test_only_a_loop_functor_declares_the_loop_and_its_tally():
    src = sweep_codegen.emit_functor(_op().trace())
    assert "unsigned long long* tally;" in src
    assert src.count("block_max_int(") == 3 == src.count("loop_tally(")
    assert "while (" in src and "rng.uniform_at(" in src
    lv = load_cell("lv.sweep").program()
    plain = build_sweep_op(2, lv.lv_init, lv.lv_transition, lv.lv_log_weight,
                           3, num_obs_cols=2)
    plain_src = sweep_codegen.emit_functor(plain.trace())
    # Every generated functor holds the tally; only a loop adds into it.
    assert "unsigned long long* tally;" in plain_src
    assert "while (" not in plain_src and "loop_tally(" not in plain_src


_KINDS = {"add": "float", "sub": "float", "mul": "float", "neg": "float",
          "div": "div", "lt": "compare", "le": "compare", "gt": "compare",
          "ge": "compare", "and": "logical", "or": "logical",
          "not": "logical", "where": "where", "draw": "uniform",
          "log1p": "log1p"}


def _iteration_ops(loop):
    """The roofline's op classes of one loop iteration's IR."""
    kinds = collections.Counter(
        _KINDS[node.op] for fn in (loop.cond, loop.body)
        for node in fn.nodes if node.op not in ("carry", "outer"))
    return dict(kinds)


def test_the_roofline_counts_the_traced_ir_and_follows_the_events():
    from benchmark.roofline import lvssa

    fns = _op().trace().fns
    (loop,) = [n.attr for n in fns["transition"].nodes if n.op == "loop"]
    assert (loop.draws, loop.max_iters) == (2, CFG["max_iters"])
    assert _iteration_ops(loop) == lvssa.EVENT_OPS
    starts = [n.attr for n in fns["init"].nodes if n.op == "loop"]
    assert len(starts) == 2
    for start in starts:
        assert (start.draws, start.max_iters) == (1, CFG["max_iters"])
        assert _iteration_ops(start) == lvssa.ARRIVAL_OPS
    assert lvssa.arrivals_per_lane() == sum(m + 1 for m in CFG["x0_mean"])
    lw = collections.Counter(
        "float" for n in fns["log_weight"].nodes
        if n.op in ("add", "sub", "mul", "div"))
    assert dict(lw) == lvssa.LOG_WEIGHT_OPS
    live, t, n, c, events = 4096 * 100, 15, 128, 4096, 5.0e9
    arrivals = c * n * lvssa.arrivals_per_lane()
    base = lvssa.work(live, t, n, arrivals + events, c * n)
    doubled = lvssa.work(live, t, n, arrivals + 2 * events, c * n)
    assert base["arrivals"] == doubled["arrivals"]
    assert base["arrivals"][0] == arrivals
    assert doubled["events"][0] == 2 * base["events"][0] == 2 * events
    assert doubled["events"][1] == base["events"][1]
    assert doubled["stage"] == base["stage"]
    # An arrival is priced by its own, smaller, IR.
    assert sum(base["arrivals"][1]) < sum(base["events"][1])
    one, by = lvssa.filter_bound(c, n, live, t, arrivals + events)
    two, _ = lvssa.filter_bound(c, n, live, t, arrivals + 2 * events)
    assert by == "operations" and 1.9 < two / one <= 2.0
    # Fewer iterations than the start's expectation: no negative work.
    few = lvssa.work(live, t, n, 10.0, c * n)
    assert few["arrivals"][0] == 10.0 and few["events"][0] == 0.0


# --- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k1g_event_loops_are_the_plain_sweep_bit_for_bit(dev):
    c, lanes = 256, 128
    op = _op()
    words, theta = _words(c, 77, dev), _theta(c, 78, dev)
    n = torch.linspace(50.0, 128.0, c, device=dev).floor()
    n[0] = 100.0
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    launched = _build.launches[_build.GENERATED]

    def launch():
        out = op(words, y, theta, n, max_particles=lanes)
        timing.stage_device_tallies(dev)
        torch.cuda.synchronize(dev)
        timing.fold_device_tallies()
        return out

    (ll, est), card = _recorded(launch)
    assert _build.launches[_build.GENERATED] == launched + 1
    assert "loop_tally(" in op.generated_kernel().source
    (want_ll, want_est), plain = _recorded(
        lambda: op.sweep_reference(words, y, theta, n, max_particles=lanes))
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, want_ll) and torch.equal(est, want_est)
    assert [card[k] for k in LOOP_COUNTERS] == [plain[k]
                                                for k in LOOP_COUNTERS]
    assert card["sweep.loop_iters"] < card["sweep.loop_slots"]
    # A second launch adds again into the tally, which the fold emptied.
    (ll2, _), again = _recorded(launch)
    assert torch.equal(ll2, ll)
    assert [again[k] for k in LOOP_COUNTERS] == [plain[k]
                                                 for k in LOOP_COUNTERS]
