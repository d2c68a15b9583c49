"""Trace a user's sweep callbacks into a CUDA functor for K1.

The JAX builder compiles any ``jnp`` callbacks into its whole-sweep kernel
under Mosaic (``bayesssm_tpu/ops/sweep_builder.py:1-48``). Here the same
callbacks, written in ``torch``, are called once with proxy values instead
of tensors; every operation they apply is recorded, in call order, into a
small elementwise IR (:class:`TracedFn`), and the IR is emitted as a C++
functor with the ``csrc/models.cuh`` interface (``D``, ``P``, ``DY``,
``kHasAux``, ``kHasMove``, ``kHasPack``, ``init``, ``transition``,
``log_weight`` and, where given, ``aux_log_weight``, ``move``, ``pack`` and
``unpack``). ``ops/_build.py::build_generated`` compiles it into a library
of its own, where ``sweep_kernel<M>`` of ``csrc/sweep.cuh`` runs it, and
:func:`evaluate` runs the IR on tensors (the CPU's check of the tracer).

What the tracer takes (anything else raises ``ValueError`` naming the
operation and the callback): ``+ - * /`` and the comparisons, reflected
forms included; ``& | ^ ~`` on comparisons; ``torch.exp``, ``log``,
``log1p``, ``expm1``, ``sqrt``, ``sin``, ``cos``, ``tanh``, ``abs``,
``floor``, ``square``, ``neg``, ``maximum``, ``minimum``, ``clamp`` with
number bounds, ``where``, ``pow`` with a number exponent, ``logical_and``,
``logical_or``, ``logical_not``, ``zeros_like``, ``ones_like`` and
``full_like`` (and the same names as tensor methods); Python numbers,
numpy scalars and 0-d tensors as constants; the time index ``t`` in Python
arithmetic; ``rng.uniform()``, ``rng.uniforms(k)`` and ``rng.normal()``;
and a loop of the callback's own, ``rng.event_loop(cond_fn, body_fn,
carry, draws=, max_iters=)`` (``ops/rng.py::SweepRng.event_loop``), whose
condition and body are traced into sub-traces of a ``loop`` node: they
may read values closed over from the callback, but may not draw from
``rng`` or hold a loop of their own. Indexing, reductions,
``bool()``/``if`` on a traced value, tensors that are not 0-d and the
counter-threading ``rng`` methods (the SIR event loop stays a
hand-written functor) do not trace.

A ``loop`` node becomes a per-lane ``while`` loop: each lane runs its body
while its condition holds and its iterations are below ``max_iters``,
drawing at ``ctr + draws * k``; then every thread of the block takes the
block's largest iteration count, ``K``, and the chain's counter moves by
``draws * K``, as ``SirModel::transition`` does (``csrc/models.cuh``).
So every thread must call a functor that holds a loop, as K1 does; the
loop also adds the lanes' own iterations and ``K`` times the block's
lanes into the sweep op's device tally, which every generated functor
holds (``tally``, ``csrc/sweep.cuh::loop_tally``).

Each IR node becomes one C++ statement, in trace order, computed by the
function PyTorch's CUDA kernel computes for that op, rounded once: the
accurate ``expf``/``logf``/``sinf``... (no fast math, ``--fmad=false``),
IEEE division, a divisor that is a host number as PyTorch's
multiplication by its float32 reciprocal, ``pow``'s special exponents,
and ``maximum``/``minimum``/``clamp`` with PyTorch's NaN propagation.
Every draw is a statement of its own, so the counter moves as
``SweepRng``'s does. Constants are C99 hex literals of their float32
value (a Python number meets a float32 tensor as a float32 scalar;
arithmetic among Python numbers, ``t`` included, stays in int or double as
Python does it). The functor has no runtime constants, so its source, and
the library's hash, depend only on the IR.
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Const", "Node", "TracedFn", "Loop", "TracedModel", "trace_fn",
           "trace_model", "emit_functor", "evaluate", "hex_float",
           "probe", "probe_source", "op_zoo", "loop_zoo", "LOOP_ZOO_CAPS"]


class Const(NamedTuple):
    """A constant operand: a Python number (``kind`` ``"i"``, ``"d"`` or
    ``"b"``) or a 0-d tensor (``tensor`` set; its value as a float)."""

    value: object
    kind: str
    tensor: object = None


class Node(NamedTuple):
    """One IR operation: ``op`` over ``args`` (node indices or
    :class:`Const`), result ``kind`` ``"f"`` (float32 lane value), ``"b"``
    (bool lane value), ``"i"`` or ``"d"`` (a Python int or float on the
    host), ``attr`` the op's number (input index, exponent, bounds)."""

    op: str
    args: tuple
    kind: str
    attr: object = None


class TracedFn(NamedTuple):
    """A traced callback: its ``nodes`` in call order and ``outputs``
    (node indices or constants); ``single`` for a log-weight."""

    name: str
    nodes: tuple
    outputs: tuple
    single: bool


class Loop(NamedTuple):
    """The ``attr`` of a ``loop`` node, whose ``args`` are the initial
    carry: the condition's and the body's sub-traces (their inputs are
    ``carry``, ``draw`` and ``outer`` nodes, the last a node of the
    enclosing callback) and the loop's ``draws`` and ``max_iters``. Its
    results are ``loop_out`` nodes."""

    cond: TracedFn
    body: TracedFn
    draws: int
    max_iters: int


class TracedModel(NamedTuple):
    """The traced callbacks of one sweep op, keyed ``init``,
    ``transition``, ``log_weight`` and, where given, ``aux_log_weight``,
    ``move``, ``pack``, ``unpack``."""

    d: int
    p: int
    d_y: int
    d_packed: int
    fns: dict


_HOST = ("i", "d")
_UNARY = {"exp": "expf", "log": "logf", "log1p": "log1pf",
          "expm1": "expm1f", "sqrt": "sqrtf", "sin": "sinf", "cos": "cosf",
          "tanh": "tanhf", "abs": "fabsf", "floor": "floorf"}
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_LOGICAL = {"and": "&&", "or": "||", "xor": "!="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


def _reject(where: str, what: str):
    raise ValueError(f"{where}: {what} is not supported by the sweep "
                     "tracer (elementwise float32 operations only; see "
                     "ops/sweep_codegen.py)")


class _Trace:
    def __init__(self, name: str, parent: "_Trace | None" = None):
        self.name = name
        self.nodes: list = []
        self.parent = parent      # the callback's trace, for a loop's
        self.outer: dict = {}     # parent ref -> this trace's outer node
        self.looping = False      # a loop's sub-traces are being made

    def add(self, op, args, kind, attr=None) -> "Val":
        self.nodes.append(Node(op, tuple(args), kind, attr))
        return Val(self, len(self.nodes) - 1, kind)

    def operand(self, x, what: str):
        """A node index or a :class:`Const` for ``x``."""
        if isinstance(x, Val):
            if x.trace is self:
                return x.ref
            if x.trace is self.parent:
                if x.ref not in self.outer:
                    self.outer[x.ref] = self.add("outer", (), x.kind,
                                                 x.ref).ref
                return self.outer[x.ref]
            _reject(self.name, "a value traced in another callback (or in "
                    "another part of a loop)")
        if isinstance(x, (bool, np.bool_)):
            return Const(bool(x), "b")
        if isinstance(x, (int, np.integer)):
            return Const(int(x), "i")
        if isinstance(x, (float, np.floating)):
            return Const(float(x), "d")
        if isinstance(x, torch.Tensor):
            if x.ndim != 0:
                _reject(self.name, f"a captured tensor of shape "
                        f"{tuple(x.shape)} in `{what}` (only 0-d tensors)")
            if x.dtype == torch.bool:
                return Const(bool(x), "b", x)
            if not x.dtype.is_floating_point:
                return Const(int(x), "i", x)
            return Const(float(x), "d", x)
        _reject(self.name, f"an operand of type {type(x).__name__} in "
                f"`{what}`")

    def kind(self, ref) -> str:
        return ref.kind if isinstance(ref, Const) else self.nodes[ref].kind


class Val:
    """A traced value: a float32 or bool lane value, or a host number."""

    __slots__ = ("trace", "ref", "kind")
    __array_ufunc__ = None  # numpy scalars on the left defer to __r*__

    def __init__(self, trace: _Trace, ref: int, kind: str):
        self.trace = trace
        self.ref = ref
        self.kind = kind

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func)).strip("_")
        return _dispatch(name, args, kwargs or {})

    def __getattr__(self, name):
        if name in _METHODS:
            return lambda *a, **k: _dispatch(name, (self, *a), k)
        _reject(self.trace.name, f"`.{name}`")

    def __bool__(self):
        _reject(self.trace.name, "`bool()` or `if` on a traced value")

    def __getitem__(self, item):
        _reject(self.trace.name, "indexing a traced value")

    def __iter__(self):
        _reject(self.trace.name, "iterating over a traced value")

    def __len__(self):
        _reject(self.trace.name, "`len()` of a traced value")

    def __float__(self):
        _reject(self.trace.name, "`float()` of a traced value")

    def __int__(self):
        _reject(self.trace.name, "`int()` of a traced value")

    __index__ = __int__

    def __add__(self, o):
        return _binary("add", self, o)

    def __radd__(self, o):
        return _binary("add", o, self)

    def __sub__(self, o):
        return _binary("sub", self, o)

    def __rsub__(self, o):
        return _binary("sub", o, self)

    def __mul__(self, o):
        return _binary("mul", self, o)

    def __rmul__(self, o):
        return _binary("mul", o, self)

    def __truediv__(self, o):
        return _binary("div", self, o)

    def __rtruediv__(self, o):
        return _binary("div", o, self)

    def __pow__(self, o):
        return _dispatch("pow", (self, o), {})

    def __rpow__(self, o):
        _reject(self.trace.name, "a number raised to a traced power")

    def __neg__(self):
        return _dispatch("neg", (self,), {})

    def __abs__(self):
        return _dispatch("abs", (self,), {})

    def __lt__(self, o):
        return _compare("lt", self, o)

    def __le__(self, o):
        return _compare("le", self, o)

    def __gt__(self, o):
        return _compare("gt", self, o)

    def __ge__(self, o):
        return _compare("ge", self, o)

    def __eq__(self, o):
        return _compare("eq", self, o)

    def __ne__(self, o):
        return _compare("ne", self, o)

    __hash__ = None

    def __and__(self, o):
        return _logical("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logical("or", self, o)

    __ror__ = __or__

    def __xor__(self, o):
        return _logical("xor", self, o)

    __rxor__ = __xor__

    def __invert__(self):
        return _dispatch("logical_not", (self,), {})


def _innermost(*xs) -> _Trace:
    """The trace an op on ``xs`` belongs to: a loop's sub-trace when one
    operand lies in it, the callback's otherwise."""
    traces = [x.trace for x in xs if isinstance(x, Val)]
    return next((t for t in traces if t.parent is not None), traces[0])


def _binary(op: str, a, b):
    tr = _innermost(a, b)
    ra, rb = tr.operand(a, op), tr.operand(b, op)
    ka, kb = tr.kind(ra), tr.kind(rb)
    if "b" in (ka, kb):
        _reject(tr.name, f"arithmetic (`{op}`) on a bool value")
    if ka in _HOST and kb in _HOST:
        # Python arithmetic on the time index: int stays int, else double.
        kind = "i" if ka == kb == "i" and op != "div" else "d"
        return tr.add(op, (ra, rb), kind)
    if op == "div" and ka in _HOST and not isinstance(a, torch.Tensor):
        # ``number / tensor`` is ``tensor.reciprocal() * number``.
        return _binary("mul", tr.add("recip", (rb,), "f"), a)
    return tr.add(op, (ra, rb), "f")


def _compare(op: str, a, b):
    tr = _innermost(a, b)
    ra, rb = tr.operand(a, op), tr.operand(b, op)
    if "f" not in (tr.kind(ra), tr.kind(rb)):
        _reject(tr.name, f"a comparison (`{op}`) without a float32 lane "
                "value")
    if "b" in (tr.kind(ra), tr.kind(rb)):
        _reject(tr.name, f"a comparison (`{op}`) of a bool value")
    return tr.add(op, (ra, rb), "b")


def _logical(op: str, a, b):
    tr = _innermost(a, b)
    ra, rb = tr.operand(a, op), tr.operand(b, op)
    if tr.kind(ra) != "b" or tr.kind(rb) != "b":
        _reject(tr.name, f"`{op}` of a value that is not a comparison")
    return tr.add(op, (ra, rb), "b")


def _float_arg(tr: _Trace, x, op: str):
    ref = tr.operand(x, op)
    if tr.kind(ref) != "f":
        _reject(tr.name, f"`{op}` of a value that is not a float32 lane "
                "value")
    return ref


def _number(tr: _Trace, x, op: str, what: str):
    """A Python number argument, as an int or a float."""
    if x is None:
        return None
    if isinstance(x, (Val, torch.Tensor, bool)) or not isinstance(
            x, (int, float, np.integer, np.floating)):
        _reject(tr.name, f"`{op}` with a {what} that is not a number")
    if np.isnan(float(x)):
        _reject(tr.name, f"`{op}` with a NaN {what}")
    return int(x) if isinstance(x, (int, np.integer)) else float(x)


_ALIASES = {"logical_and": "and", "logical_or": "or"}
_METHODS = {*_UNARY, "square", "neg", "pow", "maximum", "minimum", "clamp",
            "logical_not", "logical_and", "logical_or"}


def _dispatch(name: str, args, kwargs):
    """A ``torch`` function (or tensor method) applied to traced values."""
    tr = _innermost(*args, *kwargs.values())
    op = _ALIASES.get(name, name)
    if op in ("add", "sub") and kwargs.get("alpha", 1) != 1:
        _reject(tr.name, f"`{name}` with alpha")
    if op == "div" and kwargs.get("rounding_mode") is not None:
        _reject(tr.name, f"`{name}` with a rounding mode")
    if op in _ARITH:
        return _binary(op, args[0], args[1])
    if op in _COMPARE:
        return _compare(op, args[0], args[1])
    if op in _LOGICAL:
        return _logical(op, args[0], args[1])
    if op == "logical_not":
        ref = tr.operand(args[0], name)
        if tr.kind(ref) != "b":
            _reject(tr.name, f"`{name}` of a value that is not a comparison")
        return tr.add("not", (ref,), "b")
    if op in _UNARY or op == "neg":
        return tr.add(op, (_float_arg(tr, args[0], name),), "f")
    if op == "square":
        return tr.add("pow", (_float_arg(tr, args[0], name),), "f", 2.0)
    if op == "pow":
        exponent = args[1] if len(args) > 1 else kwargs.get("exponent")
        e = _number(tr, exponent, name, "exponent")
        return tr.add("pow", (_float_arg(tr, args[0], name),), "f", e)
    if op in ("maximum", "minimum"):
        refs = [tr.operand(x, name) for x in args[:2]]
        kinds = [tr.kind(r) for r in refs]
        if "f" not in kinds or "b" in kinds:
            _reject(tr.name, f"`{name}` without a float32 lane value")
        return tr.add(op, refs, "f")
    if op == "clamp":
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        bounds = (_number(tr, lo, name, "bound"),
                  _number(tr, hi, name, "bound"))
        if bounds == (None, None):
            _reject(tr.name, f"`{name}` without bounds")
        return tr.add("clamp", (_float_arg(tr, args[0], name),), "f",
                      bounds)
    if op == "where":
        if len(args) != 3:
            _reject(tr.name, "`where` with one argument")
        cond = tr.operand(args[0], name)
        if tr.kind(cond) != "b":
            _reject(tr.name, "`where` on a condition that is not a "
                    "comparison")
        refs = [tr.operand(x, name) for x in args[1:]]
        if "b" in [tr.kind(r) for r in refs]:
            _reject(tr.name, "`where` choosing between bool values")
        return tr.add("where", (cond, *refs), "f")
    if op in ("zeros_like", "ones_like", "full_like"):
        fill = {"zeros_like": 0.0, "ones_like": 1.0}.get(op)
        if fill is None:
            fill = _number(tr, args[1] if len(args) > 1
                           else kwargs.get("fill_value"), name, "fill value")
        if set(kwargs) - {"fill_value"}:
            _reject(tr.name, f"`{name}` with {sorted(kwargs)}")
        return tr.add("full", (_float_arg(tr, args[0], name),), "f", fill)
    _reject(tr.name, f"`{name}`")


class _Rng:
    """The ``rng`` a traced callback sees: each draw is a node."""

    def __init__(self, trace: _Trace):
        self._trace = trace

    def _draw(self, op, what):
        if self._trace.looping:
            _reject(self._trace.name, f"{what} inside rng.event_loop's "
                    "cond_fn or body_fn (the body takes its uniforms as its "
                    "first argument)")
        return self._trace.add(op, (), "f")

    def uniform(self):
        return self._draw("uniform", "`rng.uniform()`")

    def uniforms(self, k):
        return tuple(self._draw("uniform", "`rng.uniforms()`")
                     for _ in range(int(k)))

    def normal(self):
        return self._draw("normal", "`rng.normal()`")

    def event_loop(self, cond_fn, body_fn, carry, *, draws, max_iters):
        """``SweepRng.event_loop`` as a ``loop`` node: its condition and
        body traced on proxies of the carry and the draws."""
        tr = self._trace
        if tr.looping:
            _reject(tr.name, "a nested `rng.event_loop`")
        draws, max_iters = int(draws), int(max_iters)
        if draws < 1 or max_iters < 0:
            raise ValueError(f"{tr.name}: event_loop needs draws >= 1 and "
                             "max_iters >= 0")
        refs = tuple(tr.operand(x, "event_loop carry") for x in carry)
        if any(tr.kind(r) != "f" for r in refs):
            _reject(tr.name, "an event_loop carry that is not a float32 lane "
                    "value")
        k = len(refs)
        tr.looping = True
        try:
            cond = _sub_trace(tr, "cond_fn", cond_fn, k, 0, True)
            body = _sub_trace(tr, "body_fn", body_fn, k, draws, False)
        finally:
            tr.looping = False
        loop = tr.add("loop", refs, "loop", Loop(cond, body, draws,
                                                 max_iters))
        return tuple(tr.add("loop_out", (loop.ref,), "f", j)
                     for j in range(k))

    def counter(self):
        _reject(self._trace.name, "`rng.counter()` (a loop traces through "
                "`rng.event_loop`; a callback that threads its own counter "
                "needs a hand-written functor)")

    def set_counter(self, ctr):
        _reject(self._trace.name, "`rng.set_counter()`")

    def raw_uniform_blocks(self, nblk, ctr):
        _reject(self._trace.name, "`rng.raw_uniform_blocks()`")

    def __getattr__(self, name):
        _reject(self._trace.name, f"`rng.{name}` (a loop traces through "
                "`rng.event_loop`; a callback that threads its own counter "
                "needs a hand-written functor)")


def _sub_trace(parent: _Trace, part: str, fn, k: int, draws: int,
               single: bool) -> TracedFn:
    """``fn`` traced on ``k`` carry proxies (after a tuple of ``draws``
    uniform proxies for a body) inside ``parent``'s loop."""
    name = f"{parent.name}: event_loop {part}"
    tr = _Trace(name, parent)
    u = tuple(tr.add("draw", (), "f", j) for j in range(draws))
    carry = tuple(tr.add("carry", (), "f", j) for j in range(k))
    try:
        out = fn(carry) if single else fn(u, carry)
    except (TypeError, RuntimeError) as err:
        raise ValueError(f"{name}: the callback failed under the sweep "
                         f"tracer: {err}") from err
    outs = (out,) if single else tuple(out)
    if not single and len(outs) != k:
        raise ValueError(f"{name} must return {k} columns (got "
                         f"{len(outs)})")
    refs = tuple(tr.operand(o, "return") for o in outs)
    want = "b" if single else "f"
    if any(tr.kind(r) != want for r in refs):
        _reject(name, "a condition that is not a comparison" if single
                else "a carry that is not a float32 lane value")
    return TracedFn(name, tuple(tr.nodes), refs, single)


def trace_fn(name: str, fn, args, single=False, n_out=None,
             allow_bool=False) -> TracedFn:
    """Trace ``fn`` called with ``args``, a sequence of ``"rng"``,
    ``("cols", k)`` (a tuple of ``k`` state proxies), ``("theta", p)``,
    ``("y", d_y)`` (one proxy for ``d_y == 1``, else a tuple) and ``"t"``
    (an int proxy). ``single``: one value comes back (a log-weight), else
    a tuple of ``n_out`` columns."""
    tr = _Trace(name)
    call = []
    for spec in args:
        if spec == "rng":
            call.append(_Rng(tr))
        elif spec == "t":
            call.append(tr.add("time", (), "i"))
        else:
            op = {"cols": "col", "theta": "theta", "y": "obs"}[spec[0]]
            vals = tuple(tr.add(op, (), "f", j) for j in range(spec[1]))
            call.append(vals[0] if op == "obs" and spec[1] == 1 else vals)
    try:
        out = fn(*call)
    except (TypeError, RuntimeError) as err:
        raise ValueError(f"{name}: the callback failed under the sweep "
                         f"tracer: {err}") from err
    if single:
        if isinstance(out, (tuple, list)):
            raise ValueError(f"{name} must return one value, not a tuple")
        outs = (out,)
    else:
        outs = tuple(out)
        if n_out is not None and len(outs) != n_out:
            raise ValueError(f"{name} must return {n_out} columns (got "
                             f"{len(outs)})")
    refs = tuple(tr.operand(o, "return") for o in outs)
    if not allow_bool and "b" in [tr.kind(r) for r in refs]:
        _reject(name, "returning a bool value")
    return TracedFn(name, tuple(tr.nodes), refs, single)


def trace_model(d, p, d_y, init_fn, transition_fn, log_weight_fn,
                aux_log_weight_fn=None, move_fn=None, pack_fn=None,
                unpack_fn=None) -> TracedModel:
    """Trace the callbacks of one sweep op (``SweepOp``'s contract)."""
    cols, theta, ys = ("cols", d), ("theta", p), ("y", d_y)
    fns = {
        "init": trace_fn("init_fn", init_fn, ("rng", theta), n_out=d),
        "transition": trace_fn("transition_fn", transition_fn,
                               ("rng", cols, theta, "t"), n_out=d),
        "log_weight": trace_fn("log_weight_fn", log_weight_fn,
                               (cols, theta, ys), single=True),
    }
    if aux_log_weight_fn is not None:
        fns["aux_log_weight"] = trace_fn("aux_log_weight_fn",
                                         aux_log_weight_fn,
                                         (cols, theta, ys), single=True)
    if move_fn is not None:
        fns["move"] = trace_fn("move_fn", move_fn, ("rng", cols, theta, ys),
                               n_out=d)
    d_packed = d
    if pack_fn is not None:
        fns["pack"] = trace_fn("pack_fn", pack_fn, (cols,))
        d_packed = len(fns["pack"].outputs)
        fns["unpack"] = trace_fn("unpack_fn", unpack_fn,
                                 (("cols", d_packed),), n_out=d)
    return TracedModel(int(d), int(p), int(d_y), d_packed, fns)


# --- emission ---------------------------------------------------------


def hex_float(value, double=False) -> str:
    """A C99 hex literal of ``value`` rounded to float32 (``f`` suffix),
    or of the double itself; infinities as ``INFINITY``."""
    v = float(value) if double else float(np.float32(value))
    if np.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    if np.isnan(v):
        raise ValueError("NaN constants are not supported")
    mant, exp = v.hex().split("p")
    text = mant.rstrip("0").rstrip(".") + "p" + exp + ("" if double else "f")
    return f"({text})" if v < 0 or text.startswith("-") else text


class _Emitter:
    def __init__(self, fn: TracedFn, arrays: dict, prefix: str = "v"):
        self.fn = fn
        self.arrays = arrays  # input op -> C array name
        self.prefix = prefix  # of the node variables; a loop's sub-traces
                              # take l<node>c / l<node>b, the callback v

    def kind(self, ref):
        return ref.kind if isinstance(ref, Const) else self.fn.nodes[ref].kind

    def f(self, ref) -> str:
        """``ref`` as a float32 operand."""
        if isinstance(ref, Const):
            return hex_float(float(ref.value))
        if self.fn.nodes[ref].kind in _HOST:
            return f"((float){self.prefix}{ref})"
        return f"{self.prefix}{ref}"

    def host(self, ref) -> str:
        if isinstance(ref, Const):
            if ref.kind == "i":
                return str(int(ref.value))
            return hex_float(ref.value, double=True)
        return f"{self.prefix}{ref}"

    def expr(self, node: Node) -> str:
        op, a = node.op, node.args
        if op in ("col", "theta", "obs"):
            return f"{self.arrays[op]}[{node.attr}]"
        if op == "time":
            return "t"
        if op == "uniform":
            return "rng.uniform()"
        if op == "normal":
            return "rng.normal()"
        if op == "outer":
            return f"v{node.attr}"
        if op == "carry":
            return f"{self.prefix[:-1]}_x{node.attr}"
        if op == "draw":
            return f"rng.uniform_at({self.prefix[:-1]}_ctr + {node.attr})"
        if op == "loop_out":
            return f"l{a[0]}_x{node.attr}"
        if op == "full":
            return hex_float(node.attr)
        if node.kind in _HOST:
            x, y = self.host(a[0]), self.host(a[1])
            if node.kind == "d":
                x, y = f"(double){x}", f"(double){y}"
            return f"{x} {_ARITH[op]} {y}"
        if op == "div" and self._host_operand(a[1]):
            return f"{self.f(a[0])} * {self._reciprocal(a[1])}"
        if op in _ARITH:
            return f"{self.f(a[0])} {_ARITH[op]} {self.f(a[1])}"
        if op == "recip":
            return f"1.0f / {self.f(a[0])}"
        if op == "neg":
            return f"-{self.f(a[0])}"
        if op in _UNARY:
            return f"{_UNARY[op]}({self.f(a[0])})"
        if op == "pow":
            return _pow(self.f(a[0]), node.attr)
        if op in ("maximum", "minimum"):
            x, y = self.f(a[0]), self.f(a[1])
            fn = "fmaxf" if op == "maximum" else "fminf"
            return f"({x} != {x}) ? {x} : (({y} != {y}) ? {y} : {fn}({x}, {y}))"
        if op == "clamp":
            x = self.f(a[0])
            lo, hi = node.attr
            inner = x
            if lo is not None:
                inner = f"fmaxf({inner}, {hex_float(lo)})"
            if hi is not None:
                inner = f"fminf({inner}, {hex_float(hi)})"
            return f"({x} != {x}) ? {x} : {inner}"
        if op in _COMPARE:
            return f"{self.f(a[0])} {_COMPARE[op]} {self.f(a[1])}"
        if op in _LOGICAL:
            return f"{self.b(a[0])} {_LOGICAL[op]} {self.b(a[1])}"
        if op == "not":
            return f"!{self.b(a[0])}"
        if op == "where":
            return f"{self.b(a[0])} ? {self.f(a[1])} : {self.f(a[2])}"
        raise AssertionError(op)

    def b(self, ref) -> str:
        if isinstance(ref, Const):
            return "true" if ref.value else "false"
        return f"{self.prefix}{ref}"

    def _host_operand(self, ref) -> bool:
        """A divisor PyTorch sees as a CPU scalar: a Python number, a CPU
        0-d tensor or the time index."""
        if isinstance(ref, Const):
            return ref.tensor is None or ref.tensor.device.type == "cpu"
        return self.fn.nodes[ref].kind in _HOST

    def _reciprocal(self, ref) -> str:
        if isinstance(ref, Const):
            return hex_float(np.float32(1.0) / np.float32(ref.value))
        return f"(1.0f / {self.f(ref)})"

    def statements(self) -> list:
        """One C++ statement per IR node, in trace order; a ``loop`` node
        is a block of them."""
        ctype = {"f": "float", "b": "bool", "i": "int", "d": "double"}
        lines = []
        for i, n in enumerate(self.fn.nodes):
            if n.op == "loop":
                lines += self._loop(i, n)
            else:
                lines.append(f"    const {ctype[n.kind]} {self.prefix}{i} = "
                             f"{self.expr(n)};")
        return lines

    def _loop(self, i: int, node: Node) -> list:
        """The per-lane loop of node ``i`` (module docstring): carry
        ``l<i>_x<j>``, the lane's iterations ``l<i>_k``, then the block's
        largest count moves the chain's counter and the tally."""
        loop, tag = node.attr, f"l{i}"
        cond = _Emitter(loop.cond, {}, f"{tag}c")
        body = _Emitter(loop.body, {}, f"{tag}b")
        lines = [f"    // rng.event_loop: {loop.draws} draws an iteration, "
                 f"at most {loop.max_iters}"]
        lines += [f"    float {tag}_x{j} = {self.f(r)};"
                  for j, r in enumerate(node.args)]
        lines += [f"    int {tag}_k = 0;",
                  f"    while ({tag}_k < {loop.max_iters}) {{"]
        lines += ["  " + line for line in cond.statements()]
        lines += [f"      if (!{cond.b(loop.cond.outputs[0])}) break;",
                  f"      const int {tag}_ctr = rng.ctr + {loop.draws} * "
                  f"{tag}_k;"]
        lines += ["  " + line for line in body.statements()]
        lines += [f"      {tag}_x{j} = {body.f(r)};"
                  for j, r in enumerate(loop.body.outputs)]
        lines += [f"      ++{tag}_k;", "    }",
                  f"    const int {tag}_kc = block_max_int({tag}_k);",
                  f"    rng.ctr += {loop.draws} * {tag}_kc;",
                  f"    loop_tally(tally, {tag}_k, {tag}_kc);"]
        return lines

    def body(self, out_array=None) -> list:
        lines = self.statements()
        outs = [self.f(r) for r in self.fn.outputs]
        if self.fn.single:
            lines.append(f"    return {outs[0]};")
        else:
            lines += [f"    {out_array}[{j}] = {o};"
                      for j, o in enumerate(outs)]
        return lines


def _pow(x: str, e: float) -> str:
    """PyTorch's CUDA ``pow(tensor, number)``: 0 fills 1, 1 copies, and
    2, 3, 0.5, -0.5, -1, -2 have kernels of their own."""
    special = {0.0: "1.0f", 1.0: x, 2.0: f"{x} * {x}",
               3.0: f"{x} * {x} * {x}", 0.5: f"sqrtf({x})",
               -0.5: f"rsqrtf({x})", -1.0: f"1.0f / {x}",
               -2.0: f"(float)(1.0 / (double)({x} * {x}))"}
    return special.get(float(e), f"powf({x}, {hex_float(e)})")


_SIGNATURES = {
    "init": ("void init(Rng& rng, float st[D], const float* th) const",
             {"theta": "th"}, "st"),
    "transition": ("void transition(Rng& rng, float st[D], const float* th, "
                   "int t) const", {"col": "st", "theta": "th"}, "st"),
    "log_weight": ("float log_weight(const float st[D], const float* th, "
                   "const float* y_t) const",
                   {"col": "st", "theta": "th", "obs": "y_t"}, None),
    "aux_log_weight": ("float aux_log_weight(const float st[D], "
                       "const float* th, const float* y_t) const",
                       {"col": "st", "theta": "th", "obs": "y_t"}, None),
    "move": ("void move(Rng& rng, float st[D], const float* th, "
             "const float* y_t) const",
             {"col": "st", "theta": "th", "obs": "y_t"}, "st"),
    "pack": ("void pack(const float st[D], float pk[DP]) const",
             {"col": "st"}, "pk"),
    "unpack": ("void unpack(const float pk[DP], float st[D]) const",
               {"col": "pk"}, "st"),
}


def emit_functor(model: TracedModel) -> str:
    """The C++ functor ``GenModel`` (``csrc/models.cuh`` interface)."""
    fns = model.fns
    lines = [
        "// Traced from the sweep callbacks by ops/sweep_codegen.py.",
        "struct GenModel {",
        f"  static constexpr int D = {model.d};",
        f"  static constexpr int P = {model.p};",
        f"  static constexpr int DY = {model.d_y};",
        f"  static constexpr int DP = {model.d_packed};",
        f"  static constexpr bool kHasAux = {str('aux_log_weight' in fns).lower()};",
        f"  static constexpr bool kHasMove = {str('move' in fns).lower()};",
        f"  static constexpr bool kHasPack = {str('pack' in fns).lower()};",
    ]
    lines.append("  unsigned long long* tally;  // csrc/sweep.cuh::loop_tally")
    for key, (sig, arrays, out) in _SIGNATURES.items():
        if key in fns:
            lines += ["", f"  __device__ {sig} {{",
                      *_Emitter(fns[key], arrays).body(out), "  }"]
    lines.append("};")
    return "\n".join(lines) + "\n"


# --- evaluation on tensors -----------------------------------------------


# The Python operators the callbacks applied, for the evaluator.
_PY_OPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv, "lt": operator.lt, "le": operator.le,
           "gt": operator.gt, "ge": operator.ge, "eq": operator.eq,
           "ne": operator.ne, "and": operator.and_, "or": operator.or_,
           "xor": operator.xor}


def _value(vals, ref):
    if isinstance(ref, Const):
        return ref.tensor if ref.tensor is not None else ref.value
    return vals[ref]


def evaluate(fn: TracedFn, *, rng=None, cols=(), theta=(), y_t=None, t=0):
    """Run ``fn``'s IR on tensors with the ops its callback called, in the
    same order: equal, bit for bit, to calling the callback itself on the
    same device, and ``rng`` (a ``SweepRng``) moves as the callback moved
    it."""
    ys = (y_t,) if not isinstance(y_t, (tuple, list)) else tuple(y_t)
    return _run(fn, {"col": tuple(cols), "theta": tuple(theta), "obs": ys},
                rng, t)


def _run(fn: TracedFn, inputs: dict, rng, t, outer=()):
    """``evaluate`` on ``inputs`` by op; ``outer``: the enclosing
    callback's values, for a loop's sub-traces."""
    vals = []
    for node in fn.nodes:
        op = node.op
        a = [_value(vals, r) for r in node.args]
        if op in inputs:
            v = inputs[op][node.attr]
        elif op == "outer":
            v = outer[node.attr]
        elif op == "loop":
            v = _run_loop(node.attr, a, rng, t, vals)
        elif op == "loop_out":
            v = a[0][node.attr]
        elif op == "time":
            v = t
        elif op == "uniform":
            v = rng.uniform()
        elif op == "normal":
            v = rng.normal()
        elif op == "full":
            v = torch.full_like(a[0], node.attr)
        elif op in _PY_OPS:
            v = _PY_OPS[op](*a)
        elif op == "recip":
            v = torch.reciprocal(a[0])
        elif op == "neg":
            v = -a[0]
        elif op in _UNARY:
            v = getattr(torch, op)(a[0])
        elif op == "pow":
            v = torch.pow(a[0], node.attr)
        elif op in ("maximum", "minimum"):
            v = getattr(torch, op)(*a)
        elif op == "clamp":
            v = torch.clamp(a[0], *node.attr)
        elif op == "not":
            v = ~a[0]
        elif op == "where":
            v = torch.where(*a)
        else:
            raise AssertionError(op)
        vals.append(v)
    outs = tuple(_value(vals, r) for r in fn.outputs)
    return outs[0] if fn.single else outs


def _run_loop(loop: Loop, carry, rng, t, outer):
    """A ``loop`` node run by ``rng.event_loop`` on its sub-traces."""
    def cond_fn(c):
        return _run(loop.cond, {"carry": c}, None, t, outer)

    def body_fn(u, c):
        return _run(loop.body, {"carry": c, "draw": u}, None, t, outer)

    return rng.event_loop(cond_fn, body_fn, tuple(carry), draws=loop.draws,
                          max_iters=loop.max_iters)


# --- the card's check of each op ------------------------------------------


_PROBE_TEMPLATE = """// Generated by bayesssm_tpu_torch/ops/sweep_codegen.py: do not edit.
#include <cuda_runtime.h>

#include <cmath>

namespace {{

__global__ void probe_kernel(const float* __restrict__ in,
                             float* __restrict__ out, int rows) {{
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* st = in + (size_t)r * {k};
  float* o = out + (size_t)r * {m};
{body}
}}

}}  // namespace

extern "C" int {name}(const float* in, float* out, int rows, void* stream) {{
  if (rows < 1) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(rows + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      in, out, rows);
  return (int)cudaGetLastError();
}}
"""


def probe_source(fn: TracedFn, k: int):
    """``(source, entry)`` of an elementwise kernel that runs ``fn``'s IR
    (traced with ``("cols", k)``) on each row of an ``[R, k]`` input and
    writes its outputs (bools as 0/1) into an ``[R, len(outputs)]``
    output."""
    from bayesssm_tpu_torch.ops import _build

    em = _Emitter(fn, {"col": "st"})
    lines = em.statements()
    for j, r in enumerate(fn.outputs):
        value = (f"({em.b(r)} ? 1.0f : 0.0f)" if em.kind(r) == "b"
                 else em.f(r))
        lines.append(f"    o[{j}] = {value};")
    body = "\n".join(line[2:] for line in lines)
    src = _PROBE_TEMPLATE.format(k=k, m=len(fn.outputs), body=body,
                                 name="{name}")
    entry = f"bssm_probe_{_build._unit_digest(src)}"
    return src.replace("{name}", entry), entry


def probe(fn, x: torch.Tensor):
    """Run ``fn`` (a function of ``k`` float columns returning a tuple) on
    ``x [R, k]``: on the CPU the function itself, on a CUDA tensor the
    kernel generated from its trace. Returns ``[R, outputs]`` float32."""
    if x.device.type == "cpu":
        outs = fn(tuple(x.unbind(1)))
        return torch.stack([o.to(torch.float32) for o in outs], dim=1)
    from bayesssm_tpu_torch.ops import _build

    k = x.shape[1]
    traced = trace_fn("probe", fn, (("cols", k),), allow_bool=True)
    src, entry = probe_source(traced, k)
    return _build.launch_probe(src, entry, x.contiguous(),
                               len(traced.outputs))


def op_zoo(cols):
    """Every op the tracer maps, on two float columns ``(x, y)``: the
    card's check that each emitted op rounds as PyTorch's CUDA op does
    (``probe`` on the card against this function run by PyTorch)."""
    x, y = cols
    ax = torch.abs(x)
    return (
        x + y, x - y, x * y, x / y, 2.5 - x, x / 3.0, 3.0 / x, x * 0.1,
        -x, torch.exp(x), torch.log(ax), torch.log1p(ax), torch.expm1(x),
        torch.sqrt(ax), torch.sin(x), torch.cos(x), torch.tanh(x), ax,
        torch.floor(x), torch.square(x), torch.pow(x, 3), torch.pow(ax, 0.5),
        torch.pow(ax, -0.5), torch.pow(x, -1), torch.pow(x, -2),
        torch.pow(ax, 1.7), x ** 2, torch.pow(x, 0), torch.pow(x, 1),
        torch.maximum(x, y), torch.minimum(x, y),
        torch.maximum(x, torch.tensor(-1e30)), torch.clamp(x, -1.0, 2.0),
        torch.clamp(x, min=0.0), torch.clamp(x, max=0.5),
        torch.where(x < y, x, y), torch.where(x >= 0.0, 1.0, y),
        x < y, x <= y, x > 0.25, x >= y, x == y, x != y,
        (x < y) & (y > 0.0), (x < y) | (y > 0.0), (x < y) ^ (y > 0.0),
        ~(x < y), torch.logical_and(x < y, y > 0.0), torch.zeros_like(x),
        torch.full_like(x, 0.3),
    )


# The arrival loop's and the walk's iteration caps in ``loop_zoo``.
LOOP_ZOO_CAPS = (40, 6)


def loop_zoo():
    """``(init, transition, log_weight)``: sweep callbacks (two state
    columns, theta ``(a, b)``, one observation column) whose loops take
    every case the emitted per-lane loop must get right, for the card's
    check of K1g against the plain sweep, bit for bit and with equal loop
    counters. ``init`` draws before its loop and counts unit-rate
    arrivals below ``a``: a chain with ``a <= 0`` never starts it, and
    one with ``a`` above ``LOOP_ZOO_CAPS[0]`` meets the cap. The
    transition walks three draws an iteration while the time left ``r``,
    started at the arrival count, is positive or ``b > 1``, reading a
    value of its callback; lanes stop at different iterations, a chain
    of ``b > 1`` meets the cap ``LOOP_ZOO_CAPS[1]``, and a chain of
    ``a <= 0`` and ``b <= 1`` never loops; a draw after the loop reads
    the counter the loop left."""
    def init(rng, theta):
        a = theta[0]

        def running(carry):
            return carry[1] < a

        def arrive(u, carry):
            n, s = carry
            s = s - torch.log1p(-u[0])
            return torch.where(s < a, n + 1.0, n), s

        s0 = 0.25 * rng.uniform()
        return rng.event_loop(running, arrive, (torch.zeros_like(s0), s0),
                              draws=1, max_iters=LOOP_ZOO_CAPS[0])

    def transition(rng, cols, theta, t):
        n, x = cols
        b = theta[1]
        step = 0.5 * b + 0.25

        def running(carry):
            return (carry[0] > 0.0) | (b > 1.0)

        def walk(u, carry):
            r, x = carry
            r = r - torch.floor(3.0 * u[0]) - 0.5
            x = torch.where(u[1] < 0.5, x + step * u[2], x - step * u[2])
            return r, x

        r, x = rng.event_loop(running, walk, (n, x), draws=3,
                              max_iters=LOOP_ZOO_CAPS[1])
        return n, x + 0.125 * r + 0.01 * rng.normal()

    def log_weight(cols, theta, y_t):
        z = y_t - cols[1]
        return -0.5 * z * z - 0.25 * cols[0]

    return init, transition, log_weight
