"""The sweep tracer and emitter (``bayesssm_tpu_torch/ops/sweep_codegen.py``)
on the CPU, where there is no ``nvcc``: the IR it records from a model's
``torch`` callbacks, run by its evaluator, equals the callbacks bit for bit
with the same draw counter afterwards; the C++ it emits has the functor
interface, one statement per op and per draw in trace order, and literals
that round-trip float32; what it cannot take raises ``ValueError`` naming
the operation. The emitted functor's own bits are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 22)."""

import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.models.sinusoidal import (
    _sweep_init,
    _sweep_log_weight,
    _sweep_transition,
)
from bayesssm_tpu_torch.ops import _build, sweep_codegen as cg
from bayesssm_tpu_torch.ops.lgss_sweep import _lgss_op
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys
from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location(
    "torch_custom_sweep_kernel",
    ROOT / "examples" / "torch_custom_sweep_kernel.py")
EX = importlib.util.module_from_spec(spec)
spec.loader.exec_module(EX)
C, N = 3, 128


def sv_move(rng, cols, th, y_t):
    x = cols[0]
    prop = x + 0.3 * rng.normal()
    log_ratio = (EX.sv_log_weight((prop,), th, y_t)
                 - EX.sv_log_weight((x,), th, y_t))
    accept = torch.log(rng.uniform()) < log_ratio
    return (torch.where(accept, prop, x),)


def walk_transition(rng, cols, th, t):
    s, i = cols
    u = rng.uniforms(2)
    i2 = torch.clamp(i + torch.floor(u[0] * 3.0) - 1.0, min=0.0)
    grow = (i2 > i) & (u[1] < 0.9)
    return (torch.where(grow, s - 1.0, s), i2 + 0.5 * t - t / 2)


def pack(cols):
    return (cols[0] * 4096.0 + cols[1],)


def unpack(packed):
    v = packed[0]
    s = torch.floor(v * (1.0 / 4096.0))
    return (s, v - s * 4096.0)


_LGSS = _lgss_op(1.0, 1.0, "stratified", False, False)
# (callback, argument spec, inputs: cols, theta, y_t) of every model.
CASES = {
    "sv_init": (EX.sv_init, ("rng", ("theta", 3)), 1, 3, None),
    "sv_transition": (EX.sv_transition, ("rng", ("cols", 1), ("theta", 3),
                                         "t"), 1, 3, None),
    "sv_log_weight": (EX.sv_log_weight, (("cols", 1), ("theta", 3),
                                         ("y", 1)), 1, 3, 1),
    "sv_move": (sv_move, ("rng", ("cols", 1), ("theta", 3), ("y", 1)), 1, 3,
                1),
    "sinusoidal_transition": (_sweep_transition, ("rng", ("cols", 1),
                                                  ("theta", 3), "t"), 1, 3,
                              None),
    "sinusoidal_log_weight": (_sweep_log_weight, (("cols", 1), ("theta", 3),
                                                  ("y", 1)), 1, 3, 1),
    "lgss_init": (_LGSS.init_fn, ("rng", ("theta", 3)), 1, 3, None),
    "lgss_log_weight": (_LGSS.log_weight_fn, (("cols", 1), ("theta", 3),
                                              ("y", 1)), 1, 3, 1),
    "walk_transition": (walk_transition, ("rng", ("cols", 2), ("theta", 1),
                                          "t"), 2, 1, None),
    "pack": (pack, (("cols", 2),), 2, 0, None),
    "unpack": (unpack, (("cols", 1),), 1, 0, None),
}


def _inputs(d, p, d_y, seed=0):
    g = torch.Generator().manual_seed(seed)
    cols = tuple(torch.randn((C, N), generator=g) * 2.0 for _ in range(d))
    if d == 2:
        cols = tuple(torch.floor(torch.rand((C, N), generator=g) * 400.0)
                     for _ in range(d))
    row = torch.tensor([0.9, 0.4, 0.8][:p])
    theta = tuple(row[j].expand(C, N) for j in range(p))
    y_t = None if d_y is None else torch.tensor(0.7)
    return cols, theta, y_t


def _rng(seed=0):
    words = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2**32, (C, 2), dtype=np.uint64).astype(np.int64))
    return SweepRng(lane_keys(words, N))


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_equals_the_callback_bitwise(case):
    """The IR, run on tensors, gives the callback's own bits, and the draw
    counter ends where the callback's does."""
    fn, spec_, d, p, d_y = CASES[case]
    traced = cg.trace_fn(case, fn, spec_,
                         single=case.endswith("log_weight"))
    cols, theta, y_t = _inputs(d, p, d_y)
    args = {"rng": None, "cols": cols, "theta": theta, "y": y_t, "t": 7}
    rng_a, rng_b = _rng(), _rng()
    call = [rng_a if s == "rng" else args[s if isinstance(s, str) else s[0]]
            for s in spec_]
    want = fn(*call)
    got = cg.evaluate(traced, rng=rng_b, cols=cols, theta=theta, y_t=y_t,
                      t=7)
    if traced.single:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    assert torch.equal(rng_a.counter(), rng_b.counter())


def test_op_zoo_evaluates_bitwise_on_the_cpu():
    """Every mapped op (``op_zoo``): the IR evaluator and the CPU probe
    give the function's own bits."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((512, 2), generator=g) * 3.0
    x[:4] = torch.tensor([[0.0, -0.0], [math.inf, 1.0], [math.nan, 0.5],
                          [-1.0, -1.0]])
    traced = cg.trace_fn("zoo", cg.op_zoo, (("cols", 2),), allow_bool=True)
    want = cg.op_zoo(x.unbind(1))
    got = cg.evaluate(traced, cols=x.unbind(1))
    for a, b in zip(got, want):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan())
    probe = cg.probe(cg.op_zoo, x)
    assert probe.shape == (512, len(want)) and probe.dtype == torch.float32


def _loop_zoo_inputs(c, n):
    """Theta ``[C, 2]`` and ``(arrival counts, walk positions)``: chain 0
    never loops, chain 1 meets the arrival cap, chain 2 the walk's, the
    rest spread."""
    rng = np.random.default_rng(31)
    a = np.r_[0.0, 60.0, 2.0, rng.uniform(0.0, 6.0, c - 3)]
    b = np.r_[0.5, 0.5, 1.5, rng.uniform(0.0, 1.4, c - 3)]
    theta = torch.as_tensor(np.stack([a, b], 1).astype(np.float32))
    counts = rng.poisson(np.maximum(a, 0.0)[:, None], (c, n))
    counts[0] = 0
    cols = (torch.as_tensor(counts.astype(np.float32)),
            torch.as_tensor(rng.normal(0.0, 1.0, (c, n)).astype(np.float32)))
    return theta, cols


@pytest.mark.parametrize("key", ["init", "transition", "log_weight"])
def test_the_loop_zoo_evaluates_as_its_callbacks(key):
    """``loop_zoo``'s traced IR, run by the evaluator, equals its
    callbacks bit for bit, with the same counters and loop counts, and
    its inputs reach each case the card's check is for."""
    from bayesssm_tpu_torch.utils import timing

    c, n = 8, 16
    fns = dict(zip(("init", "transition", "log_weight"), cg.loop_zoo()))
    op = build_sweep_op(2, *cg.loop_zoo(), 2)
    traced = op.trace().fns[key]
    theta, cols = _loop_zoo_inputs(c, n)
    th = tuple(x[:, None].expand(c, n) for x in theta.unbind(1))
    keys = lane_keys(torch.arange(2 * c).reshape(c, 2), n)
    runs = []
    for use_ir in (True, False):
        rng = SweepRng(keys)
        args = dict(init=dict(rng=rng, theta=th),
                    transition=dict(rng=rng, cols=cols, theta=th, t=2),
                    log_weight=dict(cols=cols, theta=th,
                                    y_t=torch.tensor(0.5)))[key]
        timing.reset()
        with timing.span("call"):
            out = (cg.evaluate(traced, **args) if use_ir
                   else fns[key](*args.values()))
        (record,) = timing.recent_calls()
        timing.reset()
        out = out if isinstance(out, tuple) else (out,)
        runs.append((out, rng.counter(), record["counters"]))
    (got, ctr, counted), (want, want_ctr, want_counted) = runs
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert torch.equal(ctr, want_ctr) and counted == want_counted
    ran = ctr[:, 0]
    if key == "init":
        # One draw before the loop, then one an iteration.
        assert int(ran[0]) == 1
        assert int(ran[1]) == 1 + cg.LOOP_ZOO_CAPS[0]
        assert int(got[0][1].max()) < 60
    elif key == "transition":
        # Three draws an iteration, then the normal's two.
        assert int(ran[0]) == 2
        assert int(ran[2]) == 3 * cg.LOOP_ZOO_CAPS[1] + 2
        assert len(set(((ran[3:] - 2) // 3).tolist())) > 1
    else:
        assert "sweep.loop_iters" not in counted
    if key != "log_weight":
        assert 0 < counted["sweep.loop_iters"] < counted["sweep.loop_slots"]


def test_the_loop_zoo_sweeps_on_the_cpu():
    op = build_sweep_op(2, *cg.loop_zoo(), 2)
    theta, _ = _loop_zoo_inputs(16, 1)
    words = torch.arange(32).reshape(16, 2)
    y = torch.linspace(-1.0, 1.0, 5)
    ll, est = op(words, y, theta, torch.full((16,), 100.0),
                 max_particles=128)
    assert torch.isfinite(ll).all() and est.shape == (16, 6, 2)
    src = op.generated_kernel().source
    assert src.count("while (") == 2 == src.count("loop_tally(")


def _sv_op(**kw):
    return build_sweep_op(1, EX.sv_init, EX.sv_transition, EX.sv_log_weight,
                          3, **kw)


def test_the_source_and_its_hash_are_deterministic():
    a = _sv_op().generated_kernel()
    b = _sv_op(resample_fn="systematic", obs_gaps=(1, 2)).generated_kernel()
    assert a.source == b.source and a.entry == b.entry
    assert a.entry == _build.generated_entry(a.source)
    assert re.fullmatch(r"bssm_sweep_gen_[0-9a-f]{16}", a.entry)
    assert a.consts == ()
    # Another constant is another functor and another library.
    other = build_sweep_op(
        1, EX.sv_init, EX.sv_transition,
        lambda cols, th, y_t: EX.sv_log_weight(cols, th, y_t) + 1.0, 3)
    assert other.generated_kernel().entry != a.entry
    # Tracing is cached on the op; nothing is built on the CPU.
    op = _sv_op()
    assert op.generated_kernel() is op.generated_kernel()
    assert not any(k.startswith("bssm_sweep_gen_")
                   for k in _build._generated)


FLAGS = {
    "bpf": (dict(), dict(D=1, P=3, DY=1, kHasAux="false", kHasMove="false",
                         kHasPack="false")),
    "apf": (dict(aux_log_weight_fn=EX.sv_log_weight),
            dict(kHasAux="true", kHasMove="false")),
    "rmpf": (dict(move_fn=sv_move), dict(kHasAux="false", kHasMove="true")),
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_functor_flags(case):
    kw, want = FLAGS[case]
    src = _sv_op(**kw).generated_kernel().source
    for name, value in want.items():
        kind = "bool" if name.startswith("k") else "int"
        assert f"static constexpr {kind} {name} = {value};" in src
    assert ("aux_log_weight(" in src) == ("aux_log_weight_fn" in kw)
    assert ("void move(" in src) == ("move_fn" in kw)


def test_packed_functor_flags():
    op = build_sweep_op(2, lambda rng, th: (th[0] * 0.0, th[0] * 0.0),
                        walk_transition, lambda c, th, y: c[1] * y, 1,
                        pack_fn=pack, unpack_fn=unpack)
    model = op.trace()
    assert model.d_packed == 1
    src = cg.emit_functor(model)
    for line in ("static constexpr int D = 2;",
                 "static constexpr int DP = 1;",
                 "static constexpr bool kHasPack = true;",
                 "void pack(const float st[D], float pk[DP]) const",
                 "void unpack(const float pk[DP], float st[D]) const"):
        assert line in src
    with pytest.raises(ValueError, match="must return 2 columns"):
        build_sweep_op(2, lambda rng, th: (th[0], th[0]), walk_transition,
                       lambda c, th, y: c[1], 1,
                       pack_fn=lambda cols: (cols[0],),
                       unpack_fn=lambda p: (p[0],)).trace()


def test_draws_are_statements_in_trace_order():
    src = cg.emit_functor(_sv_op(move_fn=sv_move).trace())
    move = src[src.index("void move("):]
    draws = [ln.strip() for ln in move.splitlines() if "rng." in ln]
    assert len(draws) == 2
    assert re.fullmatch(r"const float v\d+ = rng\.normal\(\);", draws[0])
    assert re.fullmatch(r"const float v\d+ = rng\.uniform\(\);", draws[1])
    # uniforms(k) is k draws, each its own statement.
    traced = cg.trace_fn("walk", walk_transition,
                         ("rng", ("cols", 2), ("theta", 1), "t"))
    assert [n.op for n in traced.nodes].count("uniform") == 2
    body = cg._Emitter(traced, {"col": "st", "theta": "th"}).body("st")
    assert sum("rng.uniform()" in ln for ln in body) == 2
    assert all(ln.strip().startswith("const float")
               for ln in body if "rng." in ln)


@pytest.mark.parametrize("value", [0.1, -0.5, 1.0 / 3.0, 0.5 * math.log(
    2 * math.pi), 1e-30, -1e30, 4096.0, 3.4e38, 1e-45, 0.0, -0.0, 7])
def test_hex_literals_round_trip_float32(value):
    lit = cg.hex_float(value)
    assert lit.endswith("f") or lit.endswith("f)")
    back = float.fromhex(lit.strip("()").rstrip("f"))
    assert np.float32(back) == np.float32(value)
    assert math.copysign(1.0, back) == math.copysign(1.0, value)
    double = float.fromhex(cg.hex_float(value, double=True).strip("()"))
    assert double == float(value)
    assert math.copysign(1.0, double) == math.copysign(1.0, value)


def test_division_follows_the_cuda_kernels():
    """A tensor divided by a number is PyTorch's multiply by the float32
    reciprocal on the card; a number over a tensor is a reciprocal and a
    multiply; tensor / tensor is an IEEE divide; the time index is Python
    arithmetic in int and double."""
    two = torch.tensor(2.0)
    traced = cg.trace_fn(
        "div", lambda c, t: (c[0] / 3.0, 3.0 / c[0], c[0] / c[1],
                             c[0] + t * 0.5, c[0] / t, two / c[0]),
        (("cols", 2), "t"))
    body = "\n".join(cg._Emitter(traced, {"col": "st"}).body("o"))
    third = cg.hex_float(np.float32(1.0) / np.float32(3.0))
    assert f"v0 * {third};" in body
    assert "1.0f / v0;" in body and "v1 / v2" not in body
    assert "v0 / v1;" in body
    assert "(double)v2 * (double)0x1p-1" in body
    assert "(1.0f / ((float)v2))" in body
    assert "0x1p+1f / v0;" in body        # a 0-d tensor over a tensor
    x = torch.randn(4, 5)
    got = cg.evaluate(traced, cols=(x, x + 3.0), t=3)
    want = (x / 3.0, 3.0 / x, x / (x + 3.0), x + 1.5, x / 3, two / x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_numpy_and_0d_constants():
    h = np.float64(0.5 * np.log(2.0 * np.pi))
    traced = cg.trace_fn(
        "consts", lambda c: (h - c[0], np.float32(2.0) * c[0],
                             torch.maximum(c[0], torch.tensor(-1e30))),
        (("cols", 1),))
    ops = [n.op for n in traced.nodes]
    assert ops == ["col", "sub", "mul", "maximum"]
    x = torch.randn(3, 4)
    got = cg.evaluate(traced, cols=(x,))
    want = (h - x, np.float32(2.0) * x, torch.maximum(x, torch.tensor(-1e30)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


REJECTED = {
    "indexing": (lambda c: (c[0][0],), "indexing"),
    "sum": (lambda c: (torch.sum(c[0]),), "sum"),
    "cumsum": (lambda c: (c[0].cumsum(0),), "cumsum"),
    "if": (lambda c: (c[0] if c[0] > 0 else -c[0],), "bool"),
    "captured_tensor": (lambda c: (c[0] * torch.ones(4),), "shape"),
    "counter": (None, "counter"),
    "raw_blocks": (None, "raw_uniform_blocks"),
    "bool_arithmetic": (lambda c: ((c[0] > 0) * 2.0,), "bool"),
    "pow_tensor_exponent": (lambda c: (torch.pow(c[0], c[0]),), "pow"),
    "float": (lambda c: (float(c[0]) + c[0],), "float"),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_constructs_raise_naming_them(case):
    fn, match = REJECTED[case]
    if case == "counter":
        def fn(rng, c):
            ctr = rng.counter()
            return (c[0] + ctr,)
    elif case == "raw_blocks":
        def fn(rng, c):
            u, _ = rng.raw_uniform_blocks(1, 0)
            return (c[0] + u,)
    spec_ = ("rng", ("cols", 1)) if case in ("counter", "raw_blocks") else (
        ("cols", 1),)
    with pytest.raises(ValueError, match=match) as err:
        cg.trace_fn("my_callback", fn, spec_)
    assert "my_callback" in str(err.value)


def test_the_sir_event_loop_stays_a_hand_written_functor():
    """The SIR callbacks thread their own draw counter through a loop: the
    tracer names that, and the shipped SIR op keeps its functor."""
    from bayesssm_tpu_torch.ops.sir_sweep import _sir_op

    op, _ = _sir_op(100, 10, 8, "stratified", False, False)
    with pytest.raises(ValueError, match="counter"):
        op.trace()
    assert op.kernel.entry == "bssm_sweep_sir"
