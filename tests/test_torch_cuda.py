"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU with ``nvcc`` (``-m cuda``) and
skips without one; ``chip_smoke.py`` runs the same checks at the main
path's full shapes."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.models.lgss import simulate_lgss
from bayesssm_tpu_torch.models.sir import simulate_sir
from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.lgss_sweep import _lgss_op
from bayesssm_tpu_torch.ops.merge_select import (
    select_cols,
    select_cols_reference,
)
from bayesssm_tpu_torch.ops.sir_sweep import _sir_op
from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op, cdf_ext

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _words(c, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64),
        device=dev)


@pytest.mark.parametrize("n", [128, 512])
def test_select_kernel_bitwise(dev, n):
    rng = np.random.default_rng(n)
    r = 16
    w = rng.random((r, n)).astype(np.float32)
    w[rng.random((r, n)) < 0.3] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    lane = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    alive = torch.full((r, 1), float(n - 7), device=dev)
    cdf = cdf_ext(torch.as_tensor(w, device=dev), lane, alive)
    pos = torch.rand((r, n), device=dev)
    cols = [torch.randn((r, n), device=dev) for _ in range(3)]
    before = _build.launches["bssm_select"]
    got = select_cols(cdf, pos, cols)
    assert _build.launches["bssm_select"] == before + 1
    for a, b in zip(got, select_cols_reference(cdf, pos, cols)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo,method,alive", [
    ("SISAR", "stratified", 256), ("SISR", "systematic", 200),
    ("SIS", "stratified", 256),
])
def test_lgss_kernel_matches_plain_sweep(dev, algo, method, alive):
    _, y = simulate_lgss(11, t_val=12)
    op = _lgss_op(1.0, 1.0, method, algo == "SISR", algo == "SIS")
    c = 64
    theta = torch.tensor([[0.9, 0.6, 0.4]], device=dev).expand(c, 3)
    words = _words(c, 1, dev)
    ll, est = op(words, y, theta, float(alive), max_particles=256)
    ll_p, est_p = op.sweep_reference(words, y, theta, float(alive),
                                     max_particles=256)
    assert torch.isfinite(ll).all()
    diff = (ll - ll_p).abs()
    assert float((diff <= 1e-3).float().mean()) >= 0.99
    assert float((est - est_p).abs().median()) <= 1e-4


def test_sir_kernel_matches_plain_sweep(dev):
    _, y = simulate_sir(seed=1405)
    op, obs = _sir_op(500, 70, 8, "stratified", False, False)
    y2 = obs(torch.as_tensor(y, device=dev))
    c = 256
    theta = torch.tensor([[0.5, 0.2]], device=dev).expand(c, 2).contiguous()
    words = _words(c, 2, dev)
    before = _build.launches["bssm_sweep_sir"]
    ll, est = op(words, y2, theta, 128)
    ll2, _ = op(words, y2, theta, 128)
    assert _build.launches["bssm_sweep_sir"] == before + 2
    ll_p, _ = op.sweep_reference(words, y2, theta, 128)
    assert torch.equal(ll, ll2) and torch.isfinite(est).all()
    assert float(((ll - ll_p).abs() <= 1e-3).float().mean()) >= 0.99


def _example():
    """``examples/torch_custom_sweep_kernel.py``: the user's SV callbacks."""
    path = ROOT / "examples" / "torch_custom_sweep_kernel.py"
    spec = importlib.util.spec_from_file_location("torch_custom_sweep_kernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sv_move(rng, cols, th, y_t):
    """The RMPF move of ``tests/test_sweep_builder.py:43-48``."""
    lw = _example().sv_log_weight
    x = cols[0]
    prop = x + 0.3 * rng.normal()
    log_ratio = lw((prop,), th, y_t) - lw((x,), th, y_t)
    accept = torch.log(rng.uniform()) < log_ratio
    return (torch.where(accept, prop, x),)


def _walk_init(rng, th):
    return (th[0] * 0.0 + 400.0, th[0] * 0.0 + 20.0)


def _walk_transition(rng, cols, th, t):
    """An integer (S, I) walk: I moves by -1, 0 or 1 and S pays for each
    step up."""
    s, i = cols
    i2 = torch.clamp(i + torch.floor(rng.uniform() * 3.0) - 1.0, min=0.0)
    return (torch.where(i2 > i, s - 1.0, s), i2)


def _walk_log_weight(cols, th, y_t):
    lam = cols[1] + th[0]
    return y_t * torch.log(lam) - lam


def _pack(cols):
    """The SIR pack pair of ``ops/sir_sweep_pallas.py:184-193``."""
    return (cols[0] * 4096.0 + cols[1],)


def _unpack(packed):
    v = packed[0]
    s = torch.floor(v * (1.0 / 4096.0))
    return (s, v - s * 4096.0)


def _traced_case(case):
    """(op, y, theta row) of one traced-callback case."""
    from bayesssm_tpu_torch.models.stochastic_volatility import simulate_sv

    ex = _example()
    _, y = simulate_sv(1405, 12)
    sv = (1, ex.sv_init, ex.sv_transition, ex.sv_log_weight, 3)
    theta = [0.95, 0.3, -1.0]
    if case == "bpf":
        return build_sweep_op(*sv), y, theta
    if case == "apf":
        return build_sweep_op(*sv, aux_log_weight_fn=ex.sv_log_weight), y, theta
    if case == "rmpf":
        return (build_sweep_op(*sv, move_fn=_sv_move, always_resample=True),
                y, theta)
    if case == "gapped":
        return (build_sweep_op(*sv, resample_fn="systematic",
                               obs_gaps=(1, 2, 1, 1, 3, 1, 1, 2, 1, 1, 2, 1)),
                y, theta)
    op = build_sweep_op(2, _walk_init, _walk_transition, _walk_log_weight, 1,
                        pack_fn=_pack, unpack_fn=_unpack, always_resample=True)
    return op, np.abs(np.round(20 + 3 * y)), [0.5]


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("case", ["bpf", "apf", "rmpf", "gapped", "packed"])
def test_traced_callbacks_launch_the_generated_kernel(dev, case, n):
    """User callbacks without a functor (SV; an integer walk with the SIR
    pack pair): one ``bssm_sweep_generated`` launch per call, bit for bit
    equal to the plain sweep of the same callbacks on the card."""
    op, y, row = _traced_case(case)
    c = 64
    gen = torch.Generator(device=dev).manual_seed(25)
    theta = (torch.tensor([row], device=dev)
             * torch.exp(0.05 * torch.randn((c, len(row)), device=dev,
                                            generator=gen))).contiguous()
    theta[:, 0].clamp_(max=0.99)      # SV's phi stays inside (0, 1)
    counts = torch.linspace(n // 2, n, c, device=dev).round()
    words = _words(c, 26, dev)
    before = dict(_build.launches)
    ll, est = op(words, y, theta, counts, max_particles=n)
    ll2, _ = op(words, y, theta, counts, max_particles=n)
    after = dict(_build.launches)
    assert after.pop("bssm_sweep_generated") == before.pop(
        "bssm_sweep_generated") + 2
    assert after == before
    ll_p, est_p = op.sweep_reference(words, y, theta, counts, max_particles=n)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all() and torch.equal(ll, ll2)
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


def test_untraceable_callback_raises_on_cuda(dev):
    """A callback with an op the tracer does not take raises ValueError
    naming it, with no launch and no plain-sweep result."""
    ex = _example()
    op = build_sweep_op(1, ex.sv_init, ex.sv_transition,
                        lambda cols, th, y_t: cols[0] - cols[0].sum(), 3)
    theta = torch.tensor([[0.95, 0.3, -1.0]], device=dev).expand(2, 3)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="sum"):
        op(_words(2, 3, dev), torch.zeros(3), theta, 128)
    assert _build.launches == before


def test_generated_sinusoidal_functor_equals_k1c(dev):
    """The functor generated from the port's own sinusoidal callbacks
    (``models/sinusoidal.py``) equals the hand-written K1c bit for bit."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        _sinusoidal_op,
        _sweep_init,
        _sweep_log_weight,
        _sweep_transition,
        simulate_sinusoidal,
    )

    _, y = simulate_sinusoidal(1405, 20)
    traced = build_sweep_op(1, _sweep_init, _sweep_transition,
                            _sweep_log_weight, 3)
    c = 64
    gen = torch.Generator(device=dev).manual_seed(27)
    theta = (torch.tensor([[0.8, 1.0, 0.5]], device=dev)
             * torch.exp(0.1 * torch.randn((c, 3), device=dev,
                                           generator=gen))).contiguous()
    words = _words(c, 28, dev)
    _build.reset_launches()
    got = traced(words, y, theta, 128)
    want = _sinusoidal_op()(words, y, theta, 128)
    assert _build.launches["bssm_sweep_generated"] == 1
    assert _build.launches["bssm_sweep_sinusoidal"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_every_traced_op_rounds_as_pytorch_does(dev):
    """``sweep_codegen.op_zoo`` (every op the tracer maps) through its
    generated elementwise kernel against PyTorch's own CUDA ops, bit for
    bit, NaN for NaN, on values that reach the ops' special cases."""
    from bayesssm_tpu_torch.ops.sweep_codegen import op_zoo, probe

    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn((4096, 2), device=dev, generator=gen) * torch.exp(
        3.0 * torch.randn((4096, 2), device=dev, generator=gen))
    x[:8] = torch.tensor([[0.0, -0.0], [-0.0, 0.0], [1.0, 1.0],
                          [float("inf"), 2.0], [float("-inf"), -1.0],
                          [float("nan"), 0.5], [0.5, float("nan")],
                          [1e-40, -3.0]], device=dev)
    got = probe(op_zoo, x)
    want = torch.stack([o.to(torch.float32) for o in op_zoo(x.unbind(1))],
                       dim=1)
    torch.cuda.synchronize()
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    bad = [j for j in range(got.shape[1]) if not bool(same[:, j].all())]
    assert not bad, f"op_zoo outputs {bad} differ"


def test_the_loop_zoo_runs_on_the_card_as_its_plain_sweep(dev):
    """``sweep_codegen.loop_zoo`` (every case of the emitted per-lane
    loop) through K1g against its plain sweep on the card, bit for bit,
    with the same loop counters."""
    from bayesssm_tpu_torch.ops.sweep_codegen import loop_zoo
    from bayesssm_tpu_torch.utils import timing

    c = 512
    rng = np.random.default_rng(41)
    a = np.r_[0.0, 60.0, 2.0, rng.uniform(0.0, 6.0, c - 3)]
    b = np.r_[0.5, 0.5, 1.5, rng.uniform(0.0, 1.4, c - 3)]
    theta = torch.as_tensor(np.stack([a, b], 1).astype(np.float32),
                            device=dev)
    n = torch.as_tensor(rng.integers(50, 129, c).astype(np.float32),
                        device=dev)
    y = torch.linspace(-1.0, 1.0, 8, device=dev)
    words = _words(c, 42, dev)
    op = build_sweep_op(2, *loop_zoo(), 2)
    runs = []
    for fn in (op, op.sweep_reference):
        timing.reset()
        with timing.span("call"):
            out = fn(words, y, theta, n, max_particles=128)
            timing.stage_device_tallies(dev)
            torch.cuda.synchronize(dev)
            timing.fold_device_tallies()
        (record,) = timing.recent_calls()
        runs.append((out, {k: record["counters"].get(k) for k in
                           ("sweep.loop_iters", "sweep.loop_slots")}))
    timing.reset()
    ((ll, est), counted), ((want_ll, want_est), want_counted) = runs
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, want_ll) and torch.equal(est, want_est)
    assert counted == want_counted and counted["sweep.loop_iters"] > 0


@pytest.mark.parametrize("method", ["stratified", "systematic",
                                    "multinomial"])
@pytest.mark.parametrize("always", [False, True])
def test_fused_resample_kernel_bitwise(dev, method, always):
    from bayesssm_tpu_torch.ops.resampling import _positions
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample,
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    c, n, d = 64, 200, 2          # a lane count that is not a power of 2
    gen = torch.Generator(device=dev).manual_seed(3)
    alive = torch.randint(n // 2, n + 1, (c,), device=dev,
                          generator=gen).to(torch.float32)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    scale = 0.1 + 3.0 * torch.rand((c, 1), device=dev, generator=gen)
    lw = torch.where(live, scale * torch.randn((c, n), device=dev,
                                               generator=gen), -1e30)
    parts = torch.randn((c, n, d), device=dev, generator=gen)
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    thr = alive / 2.0
    words = _words(c, 4, dev)
    pos = _positions(words, method, n, alive)
    before = _build.launches["bssm_fused_resample"]
    got = fused_weight_resample_seeded(lw, parts, words, alive, uni, thr,
                                       method, always)
    want = fused_weight_resample_reference(
        lw, parts, uni, thr, key_words=words, num_alive=alive,
        method=method, always_resample=always)
    got_h = fused_weight_resample(lw, parts, pos, uni, thr, always)
    want_h = fused_weight_resample_reference(lw, parts, uni, thr,
                                             positions=pos,
                                             always_resample=always)
    assert _build.launches["bssm_fused_resample"] == before + 2
    for a, b in zip((*got, *got_h), (*want, *want_h)):
        assert torch.equal(a, b)


def test_gillespie_kernel_bitwise(dev):
    from bayesssm_tpu_torch.ops.gillespie import (
        gillespie_step,
        gillespie_step_reference,
    )

    c, n = 128, 96
    gen = torch.Generator(device=dev).manual_seed(5)
    s = torch.randint(250, 431, (c, n), device=dev, generator=gen)
    i = torch.minimum(torch.randint(0, 120, (c, n), device=dev,
                                    generator=gen), 500 - s)
    i[::16] = 0
    state = torch.stack([s, i], dim=-1).to(torch.float32)
    lam = 0.3 + 0.5 * torch.rand(c, device=dev, generator=gen)
    gam = 0.1 + 0.2 * torch.rand(c, device=dev, generator=gen)
    words = _words(c, 6, dev)
    before = _build.launches["bssm_gillespie"]
    got = gillespie_step(words, state, lam, gam, 500)
    assert _build.launches["bssm_gillespie"] == before + 1
    assert torch.equal(got, gillespie_step_reference(words, state, lam, gam,
                                                     500))


def test_engine_auto_routes_through_both_kernels(dev):
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model

    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=5)
    fns, _, _ = sir_model(100, 10, transition="gillespie_pallas")
    words = _words(32, 8, dev)
    _build.reset_launches()
    res = bootstrap_filter(words, y, 128, *fns,
                           theta=dict(lam=0.4, gamma=0.25),
                           return_particles=False)
    assert _build.launches["bssm_fused_resample"] == 5
    assert _build.launches["bssm_gillespie"] == 5
    # The kernels' plain versions on CPU give the same chains.
    cpu = bootstrap_filter(words.cpu(), y, 128, *fns,
                           theta=dict(lam=0.4, gamma=0.25),
                           use_fused="interpret-inkernel",
                           return_particles=False)
    diff = (res.loglike.cpu() - cpu.loglike).abs()
    assert float((diff <= 1e-3).float().mean()) >= 0.9


def test_sir_kernel_bitwise_at_1024_lanes(dev):
    """K1 with the SIR functor at the widest lane bound ``pmmh()`` can
    choose (a tuned count of up to 1000 rounds up to 1024 lanes), chains'
    counts spread over 50..1000: bitwise equal to the plain sweep."""
    _, y = simulate_sir(seed=1405)
    op, obs = _sir_op(500, 70, 8, "stratified", False, False)
    y2 = obs(torch.as_tensor(y, device=dev))
    c = 64
    gen = torch.Generator(device=dev).manual_seed(11)
    theta = (torch.tensor([[0.5, 0.2]], device=dev)
             * torch.exp(0.1 * torch.randn((c, 2), device=dev,
                                           generator=gen))).contiguous()
    n = torch.linspace(50, 1000, c, device=dev).round()
    words = _words(c, 12, dev)
    before = _build.launches["bssm_sweep_sir"]
    ll, est = op(words, y2, theta, n, max_particles=1024)
    assert _build.launches["bssm_sweep_sir"] == before + 1
    ll_p, est_p = op.sweep_reference(words, y2, theta, n, max_particles=1024)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


def test_gillespie_kernel_bitwise_at_1024_lanes(dev):
    from bayesssm_tpu_torch.ops.gillespie import (
        gillespie_step,
        gillespie_step_reference,
    )

    c, n = 32, 1024
    gen = torch.Generator(device=dev).manual_seed(13)
    s = torch.randint(250, 431, (c, n), device=dev, generator=gen)
    i = torch.minimum(torch.randint(0, 120, (c, n), device=dev,
                                    generator=gen), 500 - s)
    i[::8] = 0
    state = torch.stack([s, i], dim=-1).to(torch.float32)
    lam = 0.3 + 0.5 * torch.rand(c, device=dev, generator=gen)
    gam = 0.1 + 0.2 * torch.rand(c, device=dev, generator=gen)
    words = _words(c, 14, dev)
    before = _build.launches["bssm_gillespie"]
    got = gillespie_step(words, state, lam, gam, 500)
    assert _build.launches["bssm_gillespie"] == before + 1
    assert torch.equal(got, gillespie_step_reference(words, state, lam, gam,
                                                     500))


def test_pmmh_tuning_on_the_card_matches_the_cpu(dev):
    """A small ``pmmh()`` through the whole-sweep path on the card tunes
    the particle counts the batched pilot gives on the CPU for the same
    keys; the card's and the CPU's pilots agree, their means within 1e-4
    (the kernel's transcendental functions may differ from the CPU's by
    an ulp)."""
    from bayesssm_tpu_torch.models.sir import sir_model, sir_sweep_pf_impl
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
    from bayesssm_tpu_torch.pmmh.tuning import run_pilot_chain

    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=6)
    fns, log_priors, transform = sir_model(100, 10)
    control = default_tune_control(pilot_m=12, pilot_reps=6)
    names = list(log_priors)
    c, seed = 4, 5
    theta0 = np.tile(np.array([0.4, 0.25], np.float32), (c, 1))
    pilots = {}
    for where in (dev, torch.device("cpu")):
        keys = threefry.fold_in(threefry.key(seed, where),
                                torch.arange(c, device=where))
        pilots[where.type] = run_pilot_chain(
            keys, y, names, (*fns, None, None),
            [log_priors[q] for q in names], theta0,
            resolve_transforms(transform, names), control,
            pf_impl=sir_sweep_pf_impl(100, 10))
    gpu, cpu = pilots["cuda"], pilots["cpu"]
    assert torch.equal(gpu["target_n"].cpu(), cpu["target_n"])
    np.testing.assert_allclose(gpu["pilot_theta_mean"].cpu().numpy(),
                               cpu["pilot_theta_mean"].numpy(), atol=1e-4)

    _build.reset_launches()
    out = pmmh("bootstrap_filter", y, 6, *fns, log_priors,
               {"lam": 0.4, "gamma": 0.25}, 2, num_chains=c,
               param_transform=transform, seed=seed, tune_control=control,
               pf_impl=sir_sweep_pf_impl(100, 10), print_summary=False)
    # The pilot's pilot_m filter calls and one pilot_run call; the initial
    # evaluation and the m - 1 = 5 MH steps.
    assert _build.launches["bssm_sweep_sir"] == (control.pilot_m + 1) + 6
    np.testing.assert_array_equal(out.target_n, cpu["target_n"].numpy())
    assert all(np.isfinite(v).all() for v in out.theta_chain.values())


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("algo,gapped", [("APF", False), ("RMPF", False),
                                         ("BPF", True), ("APF", True)])
def test_sir_kernel_apf_rmpf_gaps_bitwise(dev, algo, gapped, n):
    """K1's APF stage, RMPF move and gap loop against the plain sweep, bit
    for bit, with per-chain counts below the lane bound."""
    _, y = simulate_sir(seed=1405)
    gaps = (1, 2, 1, 1, 3, 1, 1, 2, 1, 1) if gapped else None
    op, obs = _sir_op(500, 70, 8, "stratified", algo == "RMPF", False, algo,
                      2, gaps)
    y2 = obs(torch.as_tensor(y, device=dev))
    c = 64
    gen = torch.Generator(device=dev).manual_seed(17)
    theta = (torch.tensor([[0.5, 0.2]], device=dev)
             * torch.exp(0.1 * torch.randn((c, 2), device=dev,
                                           generator=gen))).contiguous()
    counts = torch.linspace(n // 2, n, c, device=dev).round()
    words = _words(c, 18, dev)
    before = _build.launches["bssm_sweep_sir"]
    ll, est = op(words, y2, theta, counts, max_particles=n)
    assert _build.launches["bssm_sweep_sir"] == before + 1
    ll_p, est_p = op.sweep_reference(words, y2, theta, counts,
                                     max_particles=n)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


def test_lgss_kernel_refuses_apf(dev):
    """The LGSS functor has no aux weight: the entry point refuses an APF
    day instead of running a BPF one."""
    bpf = _lgss_op(1.0, 1.0, "stratified", False, False)
    theta = torch.tensor([[0.9, 0.6, 0.4]], device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.launch_sweep(bpf.kernel, _words(1, 1, dev),
                            torch.zeros((3, 1), device=dev), theta,
                            torch.full((1,), 128.0, device=dev),
                            torch.full((1,), 64.0, device=dev), 128, d=1,
                            mode=0, systematic=False, algorithm=1)


@pytest.mark.parametrize("n,low", [(128, 64), (1024, 50)])
def test_fused_resample_with_an_aux_column_bitwise(dev, n, low):
    """K3 as the engine's APF aux resample runs it: the aux log-weights
    clamped at -1e30 as a third column, forced, threshold 0; at 1024 lanes
    with counts down to 50, as a tuned APF pmmh() runs it."""
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    c = 256
    gen = torch.Generator(device=dev).manual_seed(19)
    alive = torch.randint(low, n + 1, (c,), device=dev,
                          generator=gen).to(torch.float32)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    aux = torch.where(live, 2.0 * torch.randn((c, n), device=dev,
                                              generator=gen), -1e30)
    parts = torch.cat([torch.randn((c, n, 2), device=dev, generator=gen),
                       aux[..., None]], dim=-1)
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    zero = torch.zeros(c, device=dev)
    words = _words(c, 20, dev)
    got = fused_weight_resample_seeded(aux, parts, words, alive, uni, zero,
                                       "stratified", True)
    want = fused_weight_resample_reference(
        aux, parts, uni, zero, key_words=words, num_alive=alive,
        method="stratified", always_resample=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("algo,method", [("SISAR", "stratified"),
                                         ("SISR", "systematic"),
                                         ("SIS", "stratified")])
def test_sinusoidal_kernel_bitwise(dev, algo, method, n):
    """K1 with the ``SinusoidalModel`` functor against the plain sweep,
    bit for bit (``sinf`` as ``torch.sin`` on the card computes it), with
    per-chain counts below the lane bound."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        _sinusoidal_op,
        simulate_sinusoidal,
    )

    _, y = simulate_sinusoidal(1405, 20)
    op = _sinusoidal_op(method, algo)
    c = 64
    gen = torch.Generator(device=dev).manual_seed(21)
    theta = (torch.tensor([[0.8, 1.0, 0.5]], device=dev)
             * torch.exp(0.1 * torch.randn((c, 3), device=dev,
                                           generator=gen))).contiguous()
    counts = torch.linspace(n // 2, n, c, device=dev).round()
    words = _words(c, 22, dev)
    before = _build.launches["bssm_sweep_sinusoidal"]
    ll, est = op(words, y, theta, counts, max_particles=n)
    assert _build.launches["bssm_sweep_sinusoidal"] == before + 1
    ll_p, est_p = op.sweep_reference(words, y, theta, counts, max_particles=n)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("gaps", [None, (1, 2, 1, 1, 3, 1, 1, 2, 1, 1)])
def test_lgss_mv_kernel_bitwise(dev, gaps, n):
    """K1 with the ``LgssMvModel`` functor (two observation columns, four
    parameters) against the plain sweep, bit for bit, contiguous and with
    the gap loop."""
    from bayesssm_tpu_torch.models.lgss import simulate_lgss_mv
    from bayesssm_tpu_torch.ops.lgss_sweep import _lgss_mv_op

    _, y = simulate_lgss_mv(5, t_val=10)
    op = _lgss_mv_op(1.0, 0.5, 1.0, "stratified", False, False, gaps)
    c = 64
    theta = torch.tensor([[0.9, 0.6, 0.4, 0.5]], device=dev).expand(
        c, 4).contiguous()
    counts = torch.linspace(n // 2, n, c, device=dev).round()
    words = _words(c, 23, dev)
    before = _build.launches["bssm_sweep_lgss_mv"]
    ll, est = op(words, y, theta, counts, max_particles=n)
    assert _build.launches["bssm_sweep_lgss_mv"] == before + 1
    ll_p, est_p = op.sweep_reference(words, y, theta, counts, max_particles=n)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


def test_sinusoidal_engine_takes_k3_every_day(dev):
    """The README model through the engine on the card: the fused weight
    step (K3) every day, the threefry kernel for the two key splits, the
    initial normals and each day's normals, no other kernel, and the
    chains of its plain version on the CPU."""
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.sinusoidal import (
        simulate_sinusoidal,
        sinusoidal_model,
    )

    from bayesssm_tpu_torch.utils import timing

    _, y = simulate_sinusoidal(1405, 8)
    fns, _, _ = sinusoidal_model()
    words = _words(32, 24, dev)
    theta = dict(phi=0.8, sigma_x=1.0, sigma_y=0.5)
    _build.reset_launches()
    before = timing.counters()
    res = bootstrap_filter(words, y, 128, *fns, theta=theta,
                           return_particles=False)
    after = timing.counters()
    assert _build.launches["bssm_fused_resample"] == 8
    assert _build.launches["bssm_threefry"] == 2 + 1 + 8
    assert sum(_build.launches.values()) == 8 + 11
    # Every day's weight step, log-likelihood, ESS record and estimate ran
    # inside K3's one launch.
    for name in ("engine.days", "engine.k3_days"):
        assert after.get(name, 0) - before.get(name, 0) == 8
    cpu = bootstrap_filter(words.cpu(), y, 128, *fns, theta=theta,
                           use_fused="interpret-inkernel",
                           return_particles=False)
    np.testing.assert_allclose(res.loglike.cpu().numpy(),
                               cpu.loglike.numpy(), rtol=0, atol=1e-3)


def _heavy_tail_state(c, n, dev, seed):
    """K4 inputs with a heavy event tail: lanes at I = 1 (or a few more)
    beside one lane a chain started at S = 380, I = 120, and every 16th
    chain with I = 0 everywhere."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randint(300, 451, (c, n), device=dev, generator=gen)
    i = torch.randint(1, 4, (c, n), device=dev, generator=gen)
    heavy = torch.randint(0, n, (c,), device=dev, generator=gen)
    rows = torch.arange(c, device=dev)
    s[rows, heavy], i[rows, heavy] = 380, 120
    i[::16] = 0
    lam = 0.4 + 0.4 * torch.rand(c, device=dev, generator=gen)
    gam = 0.1 + 0.2 * torch.rand(c, device=dev, generator=gen)
    return torch.stack([s, i], dim=-1).to(torch.float32), lam, gam


@pytest.mark.parametrize("n", [128, 1024])
def test_gillespie_kernel_bitwise_on_a_heavy_tail(dev, n):
    """K4 at the engine's widths, 4096 chains, where one lane of a chain
    runs many times the events of the others: bitwise with its plain
    version, which runs the chain's lanes together."""
    from bayesssm_tpu_torch.ops.gillespie import (
        gillespie_step,
        gillespie_step_reference,
    )

    c = 4096
    state, lam, gam = _heavy_tail_state(c, n, dev, 21 + n)
    words = _words(c, 22, dev)
    before = _build.launches["bssm_gillespie"]
    got = gillespie_step(words, state, lam, gam, 500)
    assert _build.launches["bssm_gillespie"] == before + 1
    want = gillespie_step_reference(words, state, lam, gam, 500)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[::16], state[::16])


@pytest.mark.parametrize("n", [96, 128, 1000])
def test_gillespie_kernel_bitwise_when_warps_stop_apart(dev, n):
    """K4 when the lanes of a chain stop at very different attempt counts
    from warp to warp (a warp of I = 1 lanes, a warp of I = 0 lanes, the
    rest at I up to 150), on lane counts whose warps span two chains
    (96, 1000) or not (128)."""
    from bayesssm_tpu_torch.ops.gillespie import (
        gillespie_step,
        gillespie_step_reference,
    )

    c = 256
    gen = torch.Generator(device=dev).manual_seed(n)
    s = torch.randint(250, 351, (c, n), device=dev, generator=gen)
    i = torch.randint(0, 151, (c, n), device=dev, generator=gen)
    i[:, :32] = 1
    i[:, 32:64] = 0
    state = torch.stack([s, i], dim=-1).to(torch.float32)
    lam = 0.3 + 0.5 * torch.rand(c, device=dev, generator=gen)
    gam = 0.1 + 0.2 * torch.rand(c, device=dev, generator=gen)
    words = _words(c, 23, dev)
    got = gillespie_step(words, state, lam, gam, 500)
    want = gillespie_step_reference(words, state, lam, gam, 500)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("algo,gapped", [("BPF", False), ("APF", False),
                                         ("RMPF", False), ("BPF", True)])
def test_sir_kernel_bitwise_with_spread_counts(dev, algo, gapped, n):
    """K1 with the SIR functor (one block maximum of the lanes' event
    groups per transition, the warp-level reductions and scan) against
    the plain sweep, bit for bit, with per-chain counts spread over
    50..min(n, 1000)."""
    _, y = simulate_sir(seed=1405)
    gaps = (1, 2, 1, 1, 3, 1, 1, 2, 1, 1) if gapped else None
    op, obs = _sir_op(500, 70, 8, "stratified", algo == "RMPF", False, algo,
                      2, gaps)
    y2 = obs(torch.as_tensor(y, device=dev))
    c = 128
    gen = torch.Generator(device=dev).manual_seed(29)
    theta = (torch.tensor([[0.5, 0.2]], device=dev)
             * torch.exp(0.1 * torch.randn((c, 2), device=dev,
                                           generator=gen))).contiguous()
    counts = torch.linspace(50, min(n, 1000), c, device=dev).round()
    words = _words(c, 30, dev)
    before = _build.launches["bssm_sweep_sir"]
    ll, est = op(words, y2, theta, counts, max_particles=n)
    assert _build.launches["bssm_sweep_sir"] == before + 1
    ll_p, est_p = op.sweep_reference(words, y2, theta, counts,
                                     max_particles=n)
    torch.cuda.synchronize()
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, ll_p) and torch.equal(est, est_p)


@pytest.mark.parametrize("n", [20, 48, 64])
def test_fused_resample_kernel_bitwise_narrow_blocks(dev, n):
    """K3 on blocks of one and two warps (20 lanes run on 32 threads, 48
    and 64 on 64), where the reductions and the scan have no or one
    cross-warp level: bitwise with its plain version."""
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    c, d = 256, 2
    gen = torch.Generator(device=dev).manual_seed(n)
    alive = torch.randint(n // 2, n + 1, (c,), device=dev,
                          generator=gen).to(torch.float32)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    scale = 0.1 + 3.0 * torch.rand((c, 1), device=dev, generator=gen)
    lw = torch.where(live, scale * torch.randn((c, n), device=dev,
                                               generator=gen), -1e30)
    parts = torch.randn((c, n, d), device=dev, generator=gen)
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    thr = alive / 2.0
    words = _words(c, 31, dev)
    for always in (False, True):
        got = fused_weight_resample_seeded(lw, parts, words, alive, uni, thr,
                                           "stratified", always)
        want = fused_weight_resample_reference(
            lw, parts, uni, thr, key_words=words, num_alive=alive,
            method="stratified", always_resample=always)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# The warp form of K3 and of bssm_select (one warp a row, V = 1 .. 32 lanes
# a thread): lane counts on both sides of each V, rows whose N D floats are
# not a multiple of 16 bytes, chain counts that leave the last block part
# empty, and chains that keep, resample, or meet -inf and NaN weights.
WARP_LANES = [1, 20, 33, 100, 128, 129, 200, 512, 1000, 1024]


def _same(a, b):
    """Equal values (-0 == +0), NaN where NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _k3_case(c, n, d, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.randint(max(n // 2, 1), n + 1, (c,), device=dev,
                          generator=gen).to(torch.float32)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    scale = 0.1 + 3.0 * torch.rand((c, 1), device=dev, generator=gen)
    lw = torch.where(live, scale * torch.randn((c, n), device=dev,
                                               generator=gen), -1e30)
    if c >= 3:
        lw[0] = float("-inf")              # every weight NaN after the shift
        lw[1, n // 2] = float("nan")
    parts = torch.randn((c, n, d), device=dev, generator=gen)
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    return lw, parts, uni, alive


@pytest.mark.parametrize("d", [1, 2, 3, 5])
@pytest.mark.parametrize("n", WARP_LANES)
def test_fused_resample_warp_form_bitwise(dev, n, d):
    """K3 against its plain version over lane counts, columns, chain counts
    and thresholds that keep every chain, resample every one, or split
    them; host and in-kernel positions; adaptive and forced."""
    from bayesssm_tpu_torch.ops.resampling import _positions
    from bayesssm_tpu_torch.ops.resampling_fused import (
        POSITION_METHODS,
        fused_weight_resample,
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    calls = 0
    before = _build.launches["bssm_fused_resample"]
    for c in (1, 3, 4097):
        lw, parts, uni, alive = _k3_case(c, n, d, 7 * n + d + c, dev)
        words = _words(c, n + d, dev)
        for j, (thr, always) in enumerate((
                (torch.zeros(c, device=dev), False),           # all kept
                (torch.full((c,), 2.0e3, device=dev), False),  # all resample
                (alive / 2.0, False), (alive / 2.0, True))):   # mixed; forced
            method = POSITION_METHODS[(j + n) % 3]
            got = fused_weight_resample_seeded(lw, parts, words, alive, uni,
                                               thr, method, always)
            want = fused_weight_resample_reference(
                lw, parts, uni, thr, key_words=words, num_alive=alive,
                method=method, always_resample=always)
            pos = _positions(words, method, n, alive)
            got_h = fused_weight_resample(lw, parts, pos, uni, thr, always)
            want_h = fused_weight_resample_reference(
                lw, parts, uni, thr, positions=pos, always_resample=always)
            calls += 2
            torch.cuda.synchronize()
            for a, b in zip((*got, *got_h), (*want, *want_h)):
                assert _same(a, b), (c, method, always)
    assert _build.launches["bssm_fused_resample"] == before + calls


@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("n, d, alive_n", [(128, 2, 128), (1024, 1, 1000)])
def test_fused_resample_engine_day_bitwise(dev, n, d, alive_n, always):
    """K3's engine day, the warp form (128 lanes, 2 columns) and the team
    form (1024 lanes, 1000 alive, 1 column), against its plain version on
    the same inputs: raw log-weights whose masked lanes hold 50, +inf and
    NaN; a chain whose every weight is below -1e8 (-inf log-likelihood,
    zero weights, ESS record and estimate); a chain dead on entry; a NaN
    lane; key words as a strided view of [C, T, 5, 2] day keys; and a batch
    with every chain alive. In-kernel and host positions."""
    from _k3_parent_day import day_case

    from bayesssm_tpu_torch.ops.resampling import _positions
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample,
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    calls = 0
    before = _build.launches["bssm_fused_resample"]
    for c, full in ((4097, False), (257, True)):
        lw, parts, uni, alive, words, ll, dead = day_case(
            c, n, d, alive_n, 5 * n + d + c, dev)
        if full:                           # every chain alive
            lw = torch.randn((c, n), device=dev) * 2.0
            alive = torch.full((c,), float(n), device=dev)
            uni = torch.full((c, n), 1.0 / n, device=dev)
            dead = torch.zeros(c, dtype=torch.bool, device=dev)
            ll = torch.randn(c, device=dev) * 10.0
        thr = torch.zeros(c, device=dev) if always else alive / 2.0
        log_n = torch.log(alive)
        pos = _positions(words, "stratified", n, alive)
        runs = []
        for kernel in (True, False):
            d_k, d_h = dead.clone(), dead.clone()
            day = dict(loglike=ll, log_n=log_n, estimate=True)
            if kernel:
                got = fused_weight_resample_seeded(
                    lw, parts, words, alive, uni, thr, "stratified", always,
                    dead=d_k, **day)
                got_h = fused_weight_resample(
                    lw, parts, pos, uni, thr, always, num_alive=alive,
                    dead=d_h, **day)
                calls += 2
            else:
                got = fused_weight_resample_reference(
                    lw, parts, uni, thr, key_words=words, num_alive=alive,
                    method="stratified", always_resample=always, dead=d_k,
                    **day)
                got_h = fused_weight_resample_reference(
                    lw, parts, uni, thr, positions=pos, num_alive=alive,
                    always_resample=always, dead=d_h, **day)
            runs.append((*got, d_k, *got_h, d_h))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert _same(a, b), (c, always)
        p, w, _, _, ll_out, rec, est, dead_out = runs[0][:8]
        if full:
            assert torch.isfinite(ll_out).all() and not dead_out.any()
        else:
            assert dead_out[2] and dead_out[5] and not dead_out[0]
            assert ll_out[2] == float("-inf") and rec[2] == 0
            assert not w[2].any() and not est[2].any()
            assert torch.isnan(ll_out[3])
            assert torch.isfinite(ll_out[4]) == (alive_n < n)
    assert _build.launches["bssm_fused_resample"] == before + calls


def test_the_engine_day_without_counts_is_refused(dev):
    """A day (``loglike`` given) on host positions needs ``num_alive``:
    the launcher says so before it launches."""
    c, n = 4, 128
    lw, parts = torch.zeros((c, n), device=dev), torch.zeros((c, n, 1),
                                                            device=dev)
    uni = torch.full((c, n), 1.0 / n, device=dev)
    before = _build.launches["bssm_fused_resample"]
    with pytest.raises(ValueError, match="num_alive"):
        _build.launch_fused_resample(
            lw, parts, uni, torch.zeros(c, device=dev), always=False,
            pos=torch.zeros((c, n), device=dev),
            loglike=torch.zeros(c, device=dev),
            dead=torch.zeros(c, dtype=torch.bool, device=dev),
            log_n=torch.full((c,), float(np.log(n)), device=dev))
    assert _build.launches["bssm_fused_resample"] == before


@pytest.mark.parametrize("model", ["sinusoidal", "sir"])
def test_the_engine_day_on_the_card_is_the_former_route(dev, model):
    """The engine's bootstrap filter on the card (K3 takes the whole day,
    one launch a day) against the former route, the same filter with the
    weight step's ops around K3 (tests/_k3_parent_day.py): the same
    log-likelihoods, history, ESS and particle and weight histories bit for
    bit; the state estimate to float32 sums' order. The sinusoidal model at
    1024 lanes (K3's team form), SIR at 128 (its warp form, 2 columns)."""
    from _k3_parent_day import old_bootstrap_filter

    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.sinusoidal import (
        simulate_sinusoidal,
        sinusoidal_model,
    )
    from bayesssm_tpu_torch.models.sir import sir_model

    if model == "sinusoidal":
        _, y = simulate_sinusoidal(1405, 20)
        fns, _, _ = sinusoidal_model()
        theta, n = dict(phi=0.8, sigma_x=1.0, sigma_y=0.5), 1024
    else:
        _, y = simulate_sir(seed=7, n_total=500, init_infected=70, t_max=10)
        fns, _, _ = sir_model(500, 70, transition="gillespie_pallas")
        theta, n = dict(lam=0.5, gamma=0.2), 128
    words = _words(512, 41, dev)
    _build.reset_launches()
    res = bootstrap_filter(words, y, n, *fns, theta=theta)
    assert _build.launches["bssm_fused_resample"] == len(y)
    ll, lls, ess, ph, wh, st = old_bootstrap_filter(words, y, n, *fns,
                                                    theta=theta)
    torch.cuda.synchronize()
    assert torch.isfinite(res.loglike).all()
    assert torch.equal(res.loglike, ll)
    assert torch.equal(res.loglike_history, lls)
    assert torch.equal(res.ess, ess)
    assert torch.equal(res.particles_history, ph)
    assert torch.equal(res.weights_history, wh)
    torch.testing.assert_close(res.state_est, st, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [1, 2, 3, 5])
@pytest.mark.parametrize("n", WARP_LANES)
def test_select_warp_form_bitwise(dev, n, d):
    """``bssm_select`` against searchsorted + gather over the same lane
    counts, columns and row counts; sorted and unsorted positions, a row
    whose CDF is NaN up to the sentinel, and a NaN position."""
    for r in (1, 3, 4097):
        gen = torch.Generator(device=dev).manual_seed(n * 7 + d + r)
        w = torch.rand((r, n), device=dev, generator=gen)
        w = torch.where(torch.rand((r, n), device=dev, generator=gen) < 0.3,
                        0.0, w)
        w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-30)
        lane = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
        alive = torch.randint(max(n // 2, 1), n + 1, (r, 1), device=dev,
                              generator=gen).to(torch.float32)
        cdf = cdf_ext(w, lane, alive)
        if r >= 3:
            cdf[1] = torch.where(lane[0] >= alive[1] - 1.0, 1.5,
                                 float("nan"))
        pos = torch.rand((r, n), device=dev, generator=gen).sort(dim=1).values
        if r >= 3:
            pos[2] = pos[2][torch.randperm(n, device=dev, generator=gen)]
            pos[0, 0] = float("nan")
        cols = [torch.randn((r, n), device=dev, generator=gen)
                for _ in range(d)]
        before = _build.launches["bssm_select"]
        got = select_cols(cdf, pos, cols)
        assert _build.launches["bssm_select"] == before + 1
        for a, b in zip(got, select_cols_reference(cdf, pos, cols)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [60])
def test_fused_resample_and_select_with_rows_past_shared_memory(dev, d):
    """Rows of N D floats too long for a block's shared memory (1000 x 60
    floats, 240 KB): K3 takes the warp form and gathers in place, and
    ``bssm_select`` reads its value rows in place; both bitwise."""
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    c, n = 67, 1000
    lw, parts, uni, alive = _k3_case(c, n, d, 61, dev)
    words = _words(c, 62, dev)
    for always in (False, True):
        got = fused_weight_resample_seeded(lw, parts, words, alive, uni,
                                           alive / 2.0, "stratified", always)
        want = fused_weight_resample_reference(
            lw, parts, uni, alive / 2.0, key_words=words, num_alive=alive,
            method="stratified", always_resample=always)
        torch.cuda.synchronize()
        assert all(_same(a, b) for a, b in zip(got, want))
    lane = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    cdf = cdf_ext(torch.softmax(lw.nan_to_num(0.0, 0.0, 0.0), dim=1), lane,
                  alive[:, None])
    pos = torch.rand((c, n), device=dev)
    cols = list(parts.permute(2, 0, 1).contiguous().unbind(0))
    got = select_cols(cdf, pos, cols)
    for a, b in zip(got, select_cols_reference(cdf, pos, cols)):
        assert torch.equal(a, b)
