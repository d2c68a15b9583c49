"""The threefry kernel (``csrc/threefry.cu``) and how ``ops/threefry.py``
chooses between it and its plain twin.

On the CPU: key words off the card run the plain twin and count
``threefry.plain``; the kernel's constants in its source equal the plain
twin's bit for bit; ``_build.launch_threefry`` refuses malformed key words
before it loads or launches anything; and with the card's path forced
(``_on_card``) and the launch replaced by a plain model of the kernel
(one row of keys a flat row of outputs, the counter the flat index or the
row's data), every public draw function makes one launch, counts
``threefry.kernel`` and gives the plain twin's bits, also under
``torch.func.vmap`` (the operator's vmap rule: one launch for the batch),
as do a move written for one particle, ``binomial``'s lane uniforms and a
sinusoidal engine filter. On the card (``-m cuda``, skipped here): the
kernel bit for bit with the plain twin on CUDA tensors, and the
sinusoidal and SIR engine filters, a one-particle RMPF move and
``binomial`` bit for bit with the plain twin forced. The file imports no
JAX, so the card runs it with ``--noconftest``.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.filters import resample_move_filter
from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
)
from bayesssm_tpu_torch.ops import _build, threefry
from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "bayesssm_tpu_torch" / "csrc" / "threefry.cu")


def _words(shape, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, 2**32, (*shape, 2), dtype=np.uint64).astype(
            np.int64), device=dev)


def _counters():
    c = timing._tls.counters
    return c.get("threefry.kernel", 0), c.get("threefry.plain", 0)


# Every public draw function, as (name, call on keys).
DRAWS = {
    "split": lambda k: threefry.split(k),
    "split4": lambda k: threefry.split(k, 4),
    "split20x5": lambda k: threefry.split(k, (20, 5)),
    "fold_in_int": lambda k: threefry.fold_in(k, 7),
    "fold_in_tensor": lambda k: threefry.fold_in(
        k, torch.arange(k.shape[0], device=k.device)),
    "random_bits": lambda k: threefry.random_bits(k, (37,)),
    "uniform": lambda k: threefry.uniform(k, (37,)),
    "uniform_pair": lambda k: threefry.uniform(k, (37,), -2.5, 0.75),
    "normal": lambda k: threefry.normal(k, (37,)),
}


@pytest.fixture
def no_library(monkeypatch):
    """Fail on any attempt to build or load the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_build, "load_library", refuse)


# --- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("draw", list(DRAWS))
def test_cpu_keys_run_the_plain_twin_and_count_it(draw, no_library):
    keys = _words((5,), 1)
    launched = _build.launches["bssm_threefry"]
    k0, p0 = _counters()
    DRAWS[draw](keys)
    k1, p1 = _counters()
    assert (k1 - k0, p1 - p0) == (0, 1)
    assert _build.launches["bssm_threefry"] == launched


def _source_floats(name):
    body = re.search(rf"{name}(?:\[\d+\])? = \{{?([^;}}]*)\}}?;",
                     SOURCE.read_text()).group(1)
    return [float.fromhex(v.strip().rstrip("f")) for v in body.split(",")]


@pytest.mark.parametrize("name, want", [
    ("kSmallW", threefry._ERFINV_SMALL_W),
    ("kLargeW", threefry._ERFINV_LARGE_W),
    ("kSqrt2", (threefry._SQRT2_F32,)),
    ("kNormalLo", (threefry._NORMAL_LO,)),
    ("kNormalSpan",
     (float(np.float32(1.0) - np.float32(threefry._NORMAL_LO)),)),
])
def test_kernel_float_constants_equal_the_plain_twins(name, want):
    got = _source_floats(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # Each is a float32 value, written exactly.
        assert g == float(np.float32(g)) == w


def test_kernel_rotations_and_parity_equal_the_plain_twins():
    text = SOURCE.read_text()
    rot = re.search(r"kRotations\[2\]\[4\] = \{\{([^}]*)\}, \{([^}]*)\}\}",
                    text)
    got = tuple(tuple(int(v) for v in g.split(",")) for g in rot.groups())
    assert got == threefry._ROTATIONS
    parity = re.search(r"kParity = (0x[0-9A-Fa-f]+)u;", text).group(1)
    assert int(parity, 16) == threefry._KS_PARITY


def test_kernel_forms_match_the_wrapper():
    text = SOURCE.read_text()
    names = {"split": "kSplit", "fold_in": "kFoldIn", "bits": "kBits",
             "uniform": "kUniform", "normal": "kNormal",
             "lane_uniform": "kLaneUniform"}
    for form, number in _build.THREEFRY_FORMS.items():
        assert re.search(rf"constexpr int {names[form]} = {number};", text)


@pytest.mark.parametrize("keys, kw, error", [
    (torch.zeros((4, 3), dtype=torch.int64), {}, ValueError),
    (torch.tensor(5), {}, ValueError),
    (torch.zeros((4, 2), dtype=torch.int32), {}, TypeError),
    (torch.zeros((4, 2), dtype=torch.float32), {}, TypeError),
    (torch.zeros((4, 2), dtype=torch.int64), {"form": "gamma"}, ValueError),
    (torch.zeros((4, 2), dtype=torch.int64),
     {"form": "fold_in", "data": torch.zeros(3, dtype=torch.int64)},
     RuntimeError),
    (torch.zeros((4, 2), dtype=torch.int64),
     {"form": "fold_in", "data": torch.zeros(4, dtype=torch.int32)},
     TypeError),
    (torch.zeros((2**20, 2), dtype=torch.int64),
     {"shape": (2**11,)}, ValueError),
    (torch.zeros((4, 2), dtype=torch.int64),
     {"form": "lane_uniform", "data": 3}, TypeError),
    (torch.zeros((4, 2), dtype=torch.int64),
     {"form": "lane_uniform", "data": torch.zeros((4, 3),
                                                  dtype=torch.int64)},
     RuntimeError),
    # Well-formed words on the CPU: the kernel takes CUDA tensors only.
    (torch.zeros((4, 2), dtype=torch.int64), {}, ValueError),
])
def test_the_wrapper_refuses_before_any_launch(keys, kw, error, no_library):
    kw = {"form": "normal", **kw}
    launched = _build.launches["bssm_threefry"]
    with pytest.raises(error):
        _build.launch_threefry(keys, **kw)
    assert _build.launches["bssm_threefry"] == launched


def _kernel_model(keys, form, shape=(), *, data=None, lo=0.0, span=1.0):
    """``launch_threefry`` on the CPU: the wrapper's own rows, then what
    the kernel computes for each row from the plain twin's helpers."""
    rows, data, n, out_shape = _build._threefry_rows(keys, form, shape, data)
    timing.count("threefry.kernel")
    if form in ("fold_in", "lane_uniform"):
        b0, b1 = threefry._threefry_i32(rows[:, 0], rows[:, 1], 0,
                                        data & threefry.MASK32
                                        if isinstance(data, torch.Tensor)
                                        else data)
        if form == "lane_uniform":
            return threefry._to_uniform(b0 ^ b1).reshape(out_shape)
        return torch.stack([threefry._u32(b0), threefry._u32(b1)],
                           -1).reshape(out_shape)
    b0, b1 = threefry._blocks(rows, (n,))
    if form == "split":
        out = torch.stack([threefry._u32(b0), threefry._u32(b1)], -1)
    elif form == "bits":
        out = threefry._u32(b0 ^ b1)
    else:
        if form == "normal":
            lo = threefry._NORMAL_LO
            span = float(np.float32(1.0) - np.float32(lo))
        u = torch.clamp_min(threefry._fma(threefry._to_uniform(b0 ^ b1),
                                          span, lo), lo)
        out = u if form == "uniform" else threefry._SQRT2_F32 * \
            threefry.erfinv(u)
    return out.reshape(out_shape)


@pytest.fixture
def card_path(monkeypatch):
    """The card's dispatch on CPU tensors, with the launch modelled. Like
    the launcher, the model takes only unbatched tensors: under vmap the
    operator's rule must hand it the physical batch."""
    calls = []

    def launch(keys, form, shape=(), **kw):
        data = kw.get("data")
        assert not threefry._batched(keys)
        assert not (isinstance(data, torch.Tensor) and threefry._batched(data))
        calls.append(form)
        return _kernel_model(keys, form, shape, **kw)

    monkeypatch.setattr(threefry, "_on_card", lambda keys: True)
    monkeypatch.setattr(_build, "launch_threefry", launch)
    return calls


def _plain(fn, *args):
    on_card = threefry._on_card
    threefry._on_card = lambda keys: False
    try:
        return fn(*args)
    finally:
        threefry._on_card = on_card


@pytest.mark.parametrize("lead", [(6,), (3, 4), "view", "root"])
@pytest.mark.parametrize("draw", list(DRAWS))
def test_the_card_path_launches_once_with_the_plain_twins_bits(
        draw, lead, card_path):
    if lead == "view":       # a strided view, as the engine's day keys
        keys = _plain(threefry.split, _words((6,), 2), (3, 5))[:, 1, 2]
    elif lead == "root":     # one key, as pmmh()'s root
        keys = _words((), 3)
    else:
        keys = _words(lead, 4)
    fn = DRAWS[draw]
    if draw == "fold_in_tensor":    # data against the keys' last axis
        data = torch.arange(keys.shape[-2] if keys.ndim > 1 else 6) * 977 \
            + 2**32 - 2

        def fn(k):
            return threefry.fold_in(k, data)
    want = _plain(fn, keys)
    k0, p0 = _counters()
    got = fn(keys)
    k1, p1 = _counters()
    assert (k1 - k0, p1 - p0) == (1, 0)
    assert len(card_path) == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_randint_on_the_card_path_draws_through_the_kernel(card_path):
    keys = _words((6,), 5)
    want = _plain(threefry.randint, keys, (9,), -3, 40)
    got = threefry.randint(keys, (9,), -3, 40)
    assert card_path == ["split", "bits", "bits"]
    assert torch.equal(got, want)


def _sinusoidal_pf(t_val, n, dev):
    fns, log_priors, _ = sinusoidal_model()
    _, y = simulate_sinusoidal(11, t_val)
    pf = _make_pf_loglike(np.asarray(y, np.float32), n, list(log_priors),
                          (*fns, None, None), None, "BPF", "SISAR",
                          "stratified", False, max_particles=n)
    theta = torch.tensor([[0.8, 1.0, 0.5], [0.6, 0.7, 0.4],
                          [0.9, 1.3, 0.8]], device=dev).repeat(2, 1)
    return pf, theta, len(y)


def test_a_sinusoidal_engine_filter_launches_two_splits_and_a_normal_a_day(
        card_path):
    pf, theta, t = _sinusoidal_pf(8, 64, "cpu")
    words = _words((theta.shape[0],), 6)
    want, _ = _plain(pf, words, theta)
    k0, p0 = _counters()
    got, _ = pf(words, theta)
    k1, p1 = _counters()
    # Two key splits, the initial normals, one normal a day; the CPU's
    # weight step draws its resampling uniforms, one launch a day more.
    assert card_path == ["split", "split", "normal"] + ["normal",
                                                         "uniform"] * t
    assert (k1 - k0, p1 - p0) == (3 + 2 * t, 0)
    assert torch.equal(got, want)


# Draws under torch.func.vmap, as (name, call on one key [2]).
VMAP_DRAWS = {
    "split": lambda k: threefry.split(k),
    "split20x5": lambda k: threefry.split(k, (20, 5)),
    "fold_in_int": lambda k: threefry.fold_in(k, 7),
    "random_bits": lambda k: threefry.random_bits(k, (5,)),
    "uniform_pair": lambda k: threefry.uniform(k, (), -2.5, 0.75),
    "normal": lambda k: threefry.normal(k, (3,)),
}


@pytest.mark.parametrize("in_dim", [0, 1])
@pytest.mark.parametrize("draw", list(VMAP_DRAWS))
def test_a_draw_under_vmap_is_one_launch_with_the_plain_twins_bits(
        draw, in_dim, card_path):
    keys = _words((4, 6), 11)           # vmap over axis in_dim, then 0
    fn = torch.func.vmap(torch.func.vmap(VMAP_DRAWS[draw]), in_dims=in_dim)
    want = _plain(fn, keys)
    k0, p0 = _counters()
    got = fn(keys)
    k1, p1 = _counters()
    assert (k1 - k0, p1 - p0) == (1, 0)
    assert len(card_path) == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("batched", ["data", "both"])
def test_fold_in_under_vmap_broadcasts_keys_and_data(batched, card_path):
    data = torch.arange(7) * 977 + 2**32 - 3
    if batched == "data":           # fold_in(root, d) for each datum
        root = _words((), 12)
        got = torch.func.vmap(lambda d: threefry.fold_in(root, d))(data)
        want = _plain(threefry.fold_in, root, data)
    else:                           # [3] keys a row against [3] data
        keys = _words((7, 3), 13)
        grid = data[:, None] + torch.arange(3)
        got = torch.func.vmap(threefry.fold_in)(keys, grid)
        want = _plain(threefry.fold_in, keys, grid)
    assert card_path == ["fold_in"]
    assert torch.equal(got, want)


def _drift_model():
    def init_fn(key, num_particles):
        return threefry.normal(key, (num_particles,))

    def transition_fn(key, particles, mu):
        return (particles + mu[:, None]
                + threefry.normal(key, particles.shape[1:]))

    def loglik_fn(y, particles, sigma):
        s = sigma[:, None]
        return -0.5 * (torch.log(2 * math.pi * s**2)
                       + ((y - particles) / s) ** 2)

    def move_one(key, particle, y, sigma):
        """A move written for one particle (run under vmap)."""
        k1, k2 = threefry.split(key).unbind(-2)
        proposal = particle + 0.1 * threefry.normal(k1)
        log_alpha = (-0.5 * ((y - proposal) / sigma) ** 2
                     + 0.5 * ((y - particle) / sigma) ** 2)
        accept = torch.log(threefry.uniform(k2)) < log_alpha
        return torch.where(accept, proposal, particle)

    def move_batched(key, particles, y, sigma):
        """``move_one`` for every chain and particle, without vmap:
        particle ``j`` takes key ``j`` of ``split(key, N)``, as
        ``utils/signatures.py::adapt_move_fn`` hands it out."""
        c, n = particles.shape
        keys = threefry.split(key, n).reshape(c * n, 2)
        flat, s = particles.reshape(-1), sigma.repeat_interleave(n)
        k1, k2 = threefry.split(keys).unbind(-2)
        proposal = flat + 0.1 * threefry.normal(k1)
        log_alpha = (-0.5 * ((y - proposal) / s) ** 2
                     + 0.5 * ((y - flat) / s) ** 2)
        accept = torch.log(threefry.uniform(k2)) < log_alpha
        return torch.where(accept, proposal, flat).reshape(c, n)

    return init_fn, transition_fn, loglik_fn, move_one, move_batched


def _one_particle_rmpf(words, t_val, n, batched=False):
    """An RMPF with the move written for one particle, or with its batched
    twin (the reference: the plain twin does not run under vmap on every
    PyTorch, which lacks a batching rule for ``Tensor.view(dtype)``)."""
    rng = np.random.default_rng(14)
    y = np.cumsum(rng.normal(1.0, 1.0, t_val)).astype(np.float32)
    c, dev = words.shape[0], words.device
    theta = {"mu": torch.full((c,), 1.0, device=dev),
             "sigma": torch.linspace(0.3, 0.6, c, device=dev)}
    *fns, move_one, move_batched = _drift_model()
    res = resample_move_filter(words, y, n, *fns,
                               move_batched if batched else move_one,
                               theta=theta, return_particles=False)
    return res.loglike, res.state_est


def test_a_one_particle_move_on_the_card_path_launches_per_draw(card_path):
    words = _words((3,), 15)
    want = _plain(_one_particle_rmpf, words, 6, 16, True)
    k0, p0 = _counters()
    got = _one_particle_rmpf(words, 6, 16)
    k1, p1 = _counters()
    # Per day: the transition's normals, the CPU weight step's uniforms,
    # and the move's particle keys, split, normal and uniform, each one
    # launch for every chain and particle.
    assert card_path == ["split", "split", "normal"] + [
        "normal", "uniform", "split", "split", "normal", "uniform"] * 6
    assert (k1 - k0, p1 - p0) == (len(card_path), 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("count, prob", [
    (torch.tensor([[3.0, 0.0, 7.0], [9.0, 1.0, 2.0]]), 0.3),    # inversion
    (torch.tensor([[400.0, 55.0, 120.0], [80.0, 300.0, 31.0]]), 0.4),  # BTRS
    (torch.tensor([[400.0, 3.0, 120.0], [6.0, 300.0, 2.0]]), 0.7),  # both
])
def test_binomial_draws_its_lane_uniforms_by_the_kernel(count, prob,
                                                        card_path):
    keys = _words((2,), 16)
    want = _plain(threefry.binomial, keys, count, prob)
    k0, p0 = _counters()
    got = threefry.binomial(keys, count, prob)
    k1, p1 = _counters()
    assert "lane_uniform" in card_path
    assert set(card_path) <= {"split", "lane_uniform"}
    assert (k1 - k0, p1 - p0) == (len(card_path), 0)
    assert torch.equal(got, want)


# --- the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lead, per_key", [
    ((4096,), 1024),      # the sinusoidal engine's normals
    ((64, 3), 1024),      # keys with two leading axes
    ((257,), 1001),       # a count that is no multiple of the block
    ("view", 333),        # the engine's strided day keys
])
@pytest.mark.parametrize("draw", ["split", "split4", "split20x5",
                                  "fold_in_int", "fold_in_tensor",
                                  "random_bits", "uniform", "uniform_pair",
                                  "normal"])
def test_kernel_bit_for_bit_with_the_plain_twin_on_the_card(
        draw, lead, per_key, dev):
    if lead == "view":
        keys = threefry.split(_words((300,), 7, dev), (4, 5))[:, 2, 3]
    else:
        keys = _words(lead, 8, dev)
    fns = {
        "random_bits": lambda k: threefry.random_bits(k, (per_key,)),
        "uniform": lambda k: threefry.uniform(k, (per_key,)),
        "uniform_pair": lambda k: threefry.uniform(k, (per_key,), -2.5,
                                                   0.75),
        "normal": lambda k: threefry.normal(k, (per_key,)),
        "fold_in_tensor": lambda k: threefry.fold_in(
            k, torch.arange(k.shape[-2], device=dev) * 977 + 2**32 - 5),
    }
    fn = fns.get(draw, DRAWS[draw])
    want = _plain(fn, keys)
    launched = _build.launches["bssm_threefry"]
    got = fn(keys)
    torch.cuda.synchronize()
    assert _build.launches["bssm_threefry"] == launched + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_normal_tails_and_edges_on_the_card(dev):
    # Enough draws to reach erfinv's large-w branch (|u| above ~0.9966,
    # one draw in ~300) thousands of times.
    keys = _words((512,), 9, dev)
    want = _plain(threefry.normal, keys, (4096,))
    got = threefry.normal(keys, (4096,))
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 4.0


def _sir_engine_pf(n, dev):
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model

    fns, log_priors, _ = sir_model(500, 70, transition="gillespie_pallas")
    _, y = simulate_sir(seed=1405, n_total=500, init_infected=70, t_max=10)
    pf = _make_pf_loglike(np.asarray(y, np.float32), n, list(log_priors),
                          (*fns, None, None), None, "BPF", "SISAR",
                          "stratified", False, max_particles=n)
    rng = np.random.default_rng(3)
    theta = torch.as_tensor((np.array([0.5, 0.2], np.float32) * np.exp(
        0.1 * rng.normal(size=(512, 2)))).astype(np.float32), device=dev)
    return pf, theta


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sinusoidal", "sir"])
def test_engine_filters_bit_for_bit_with_the_plain_twin_on_the_card(
        model, dev):
    if model == "sinusoidal":
        pf, theta, t = _sinusoidal_pf(20, 1024, dev)
        theta = theta.repeat(256, 1)
        launches = 2 + 1 + t
    else:
        pf, theta = _sir_engine_pf(128, dev)
        launches = 2
    words = _words((theta.shape[0],), 10, dev)
    want, est_want = _plain(pf, words, theta)
    k0, p0 = _counters()
    got, est = pf(words, theta)
    k1, p1 = _counters()
    torch.cuda.synchronize()
    assert (k1 - k0, p1 - p0) == (launches, 0)
    assert torch.equal(got, want)
    assert torch.equal(est, est_want)


@pytest.mark.cuda
def test_lane_uniforms_bit_for_bit_with_the_plain_twin_on_the_card(dev):
    sub = _words((300, 1, 4), 17, dev)
    lanes = torch.arange(1000, device=dev)[None, :, None]
    want = _plain(threefry._lane_uniforms, sub, lanes)
    launched = _build.launches["bssm_threefry"]
    got = threefry._lane_uniforms(sub, lanes)
    torch.cuda.synchronize()
    assert _build.launches["bssm_threefry"] == launched + 1
    assert got.shape == want.shape == (300, 1000, 4)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_binomial_bit_for_bit_with_the_plain_twin_on_the_card(dev):
    rng = np.random.default_rng(18)
    count = torch.as_tensor(rng.integers(0, 500, (64, 40)).astype(
        np.float32), device=dev)
    prob = torch.as_tensor(rng.uniform(0.0, 1.0, (64, 40)).astype(
        np.float32), device=dev)
    keys = _words((64,), 19, dev)
    want = _plain(threefry.binomial, keys, count, prob)
    k0, p0 = _counters()
    got = threefry.binomial(keys, count, prob)
    k1, p1 = _counters()
    assert k1 > k0 and p1 == p0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_one_particle_rmpf_move_bit_for_bit_with_the_plain_twin_on_the_card(
        dev):
    words = _words((64,), 20, dev)
    want = _plain(_one_particle_rmpf, words, 10, 128, True)
    launched = _build.launches["bssm_threefry"]
    k0, p0 = _counters()
    got = _one_particle_rmpf(words, 10, 128)
    k1, p1 = _counters()
    torch.cuda.synchronize()
    assert k1 - k0 == _build.launches["bssm_threefry"] - launched > 0
    assert p1 == p0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
