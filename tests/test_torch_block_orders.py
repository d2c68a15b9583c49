"""The block reductions and the CDF scan of the Hopper kernels
(``csrc/reduce.cuh``), and their one-warp forms (``csrc/warp_reduce.cuh``,
the fused weight step's), modelled in plain PyTorch, against the plain
versions' orders (``ops/sweep_builder.py``: ``tree_sum`` and
``running_cdf``).

The kernels keep the old halving tree and JAX's doubling scan but run the
levels inside a warp on shuffles and only the cross-warp levels through
shared memory, in a transposed layout. The models below follow
``block_reduce`` and ``block_cdf`` step by step, shuffle by shuffle, on
``[R, n]`` rows (one row a block). The one-warp forms hold a row of
n = 32 V lanes in one warp, lane t + 32 k in register k of thread t, and
are modelled register by register (``model_warp_tree``,
``model_warp_cdf``), with the interleaved upper-bound searches
(``model_search_slots``); the team form spreads a row of 128 W lanes over
W such warps of 4 registers (``model_team_tree``, ``model_team_cdf``). The sums must equal the plain orders bit for
bit, NaN payloads included; the running max may differ only in which
zero's sign or NaN payload it keeps, so its values (NaN where NaN) and the
selected indices must be equal. Inputs carry +-0, denormals, +-inf and
one NaN lane. No card is needed.
"""

import pytest
import torch

from bayesssm_tpu_torch.ops.merge_select import select_index
from bayesssm_tpu_torch.ops.resampling_fused import (
    fused_weight_resample_reference,
)
from bayesssm_tpu_torch.ops.sweep_builder import _shift, running_cdf, tree_sum

torch.set_num_threads(1)

LANES = 32


def _nan_max(a, b):
    """``select.cuh::nan_max``: a NaN first operand wins, then the larger."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _shfl(x, src):
    """``__shfl_sync`` over the last dim: lane t reads lane ``src[t]``."""
    return x[..., src]


def _down(x, s, width=LANES):
    """``__shfl_down_sync(x, s, width)``: lane t reads t + s inside its
    segment of ``width`` lanes, or keeps its own value."""
    t = torch.arange(LANES)
    k = t % width
    return _shfl(x, torch.where(k + s < width, t + s, t))


def _up(x, s, width=LANES):
    """``__shfl_up_sync(x, s, width)``: lane t reads t - s inside its
    segment, or keeps its own value."""
    t = torch.arange(LANES)
    k = t % width
    return _shfl(x, torch.where(k >= s, t - s, t))


def _transpose(n):
    """The transposed layout: warp w, lane t holds column j at depth k,
    block lane j + 32 k (``reduce.cuh::Transposed``). Returns the block
    lane ``[nw, 32]`` each thread holds, and its depth."""
    nw = n // LANES
    w = torch.arange(nw)[:, None]
    t = torch.arange(LANES)[None, :]
    j = w * (LANES // nw) + t // nw
    k = t % nw
    return j + LANES * k, k.expand(nw, LANES)


def model_reduce(x, op):
    """``block_reduce`` on rows ``x [R, n]``: the transposed cross-warp
    levels, the column totals, then the in-warp shuffle levels; the
    result every warp takes from its lane 0."""
    r, n = x.shape
    nw = n // LANES
    at, k = _transpose(n)
    y = x[:, at]                                  # [R, nw, 32]
    s = nw // 2
    while s > 0:
        y = op(y, _down(y, s, nw))
        s //= 2
    col = torch.empty(r, LANES, dtype=x.dtype)
    j = at % LANES
    col[:, j[k == 0]] = y[:, k == 0]
    z = col
    for s in (16, 8, 4, 2, 1):
        z = op(z, _down(z, s))
    return z[:, :1]


def model_cdf(w, with_max=True):
    """``block_cdf`` on rows ``w [R, n]``: the rotation-shuffle levels
    s <= 16 with the previous warp's inputs, the transposed levels
    s >= 32 with the columns' exclusive running max, then the warp's
    running max. ``with_max=False`` returns the add pass alone."""
    r, n = w.shape
    nw = n // LANES
    t = torch.arange(LANES)
    warp = torch.arange(nw)[:, None]
    v = w.reshape(r, nw, LANES)
    p = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
    for s in (1, 2, 4, 8, 16):
        send = torch.where(t + s < LANES, v, p)
        got = _shfl(send, (t - s) % LANES)
        p = p + _up(p, s)
        v = v + torch.where((t >= s) | (warp > 0), got, 0.0)
    before = torch.zeros_like(v)
    if nw > 1:
        at, k = _transpose(n)
        flat = v.reshape(r, n)
        x = flat[:, at]
        s = 1
        while s < nw:
            x = x + torch.where(k >= s, _up(x, s, nw), 0.0)
            s *= 2
        run = x
        s = 1
        while s < nw:
            run = torch.where(k >= s, _nan_max(run, _up(run, s, nw)), run)
            s *= 2
        excl = torch.where(k >= 1, _up(run, 1, nw), 0.0)
        sums = torch.empty_like(flat)
        cmax = torch.empty_like(flat)
        sums[:, at] = x
        cmax[:, at] = excl
        v = sums.reshape(r, nw, LANES)
        before = cmax.reshape(r, nw, LANES)
        for s in (16, 8, 4, 2, 1):
            before = _nan_max(before, _shfl(before, t ^ s))
    if not with_max:
        return v.reshape(r, n)
    run = _nan_max(v, torch.zeros_like(v))
    for s in (1, 2, 4, 8, 16):
        run = torch.where(t >= s, _nan_max(run, _up(run, s)), run)
    return _nan_max(run, before).reshape(r, n)


def _plain_add_pass(w):
    """The add pass of ``running_cdf``: x[l] += x[l - s], s = 1, 2, ..."""
    cdf, s = w, 1
    while s < w.shape[-1]:
        cdf = cdf + _shift(cdf, s)
        s *= 2
    return cdf


def _bits(x):
    return x.view(torch.int32)


def _rows(n, signed):
    """Eight rows of n lanes: weights from flat to peaked, +-0 and
    denormals scattered, one row with an inf lane, one with a NaN lane;
    ``signed`` adds negative values (the reductions take any sign)."""
    gen = torch.Generator().manual_seed(n)
    x = torch.rand((8, n), generator=gen) ** torch.tensor(
        [[1.0], [2.0], [8.0], [30.0], [1.0], [4.0], [1.0], [1.0]])
    x = x / x.sum(dim=1, keepdim=True)
    zero = torch.rand((8, n), generator=gen) < 0.2
    x = torch.where(zero, torch.where(torch.rand((8, n), generator=gen)
                                      < 0.5, 0.0, -0.0), x)
    tiny = torch.rand((8, n), generator=gen) < 0.1
    x = torch.where(tiny, torch.tensor(1e-40), x)
    if signed:
        x = x * torch.where(torch.rand((8, n), generator=gen) < 0.4, -1.0,
                            1.0)
    x[4, n // 3] = float("inf")
    x[5, n // 2 + 5] = float("nan")
    x[6, :] = -0.0
    return x.to(torch.float32)


@pytest.mark.parametrize("n", [32, 64, 128, 256, 1024])
def test_reductions_match_the_halving_tree(n):
    x = _rows(n, signed=True)
    got = model_reduce(x, torch.add)
    assert torch.equal(_bits(got), _bits(tree_sum(x)))
    # The max: the old kernel's halving tree with nan_max, lower first.
    want, m = x, n
    while m > 1:
        m //= 2
        want = _nan_max(want[:, :m], want[:, m:])
    assert torch.equal(_bits(model_reduce(x, _nan_max)), _bits(want))


@pytest.mark.parametrize("n", [32, 64, 128, 256, 1024])
def test_cdf_add_pass_matches_the_doubling_order(n):
    w = _rows(n, signed=True)
    assert torch.equal(_bits(model_cdf(w, with_max=False)),
                       _bits(_plain_add_pass(w)))


@pytest.mark.parametrize("n", [32, 64, 128, 256, 1024])
def test_cdf_selects_as_the_plain_version(n):
    w = _rows(n, signed=False)
    got, want = model_cdf(w), running_cdf(w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])           # -0 == +0
    assert bool(torch.isnan(got[5, n // 2 + 5:]).all())
    # With the sentinel from the last alive lane, as the kernels pin it.
    lane = torch.arange(n, dtype=torch.float32)[None, :]
    alive = torch.tensor([[n], [n - 3], [n // 2], [n], [n], [n], [n],
                          [n - 1]], dtype=torch.float32)
    ext_got = torch.where(lane >= alive - 1.0, 1.5, got)
    ext_want = torch.where(lane >= alive - 1.0, 1.5, want)
    gen = torch.Generator().manual_seed(7)
    pos = torch.rand((8, n), generator=gen).sort(dim=1).values
    pos[:, :4] = torch.tensor([0.0, 1e-40, 0.5, 1.0])
    assert torch.equal(select_index(ext_got, pos),
                       select_index(ext_want, pos))


# The one-warp forms of the fused weight step (csrc/warp_reduce.cuh): every
# V the kernel instantiates.
WARP_V = [1, 2, 4, 8, 16, 32]


def _regs(x):
    """Rows ``[R, 32 V]`` as the warp holds them: register k of thread t
    is lane t + 32 k; a list of V ``[R, 32]`` tensors."""
    return list(x.reshape(x.shape[0], -1, LANES).unbind(1))


def model_warp_tree(x, op):
    """``warp_tree`` on rows ``x [R, 32 V]``: the levels s >= 32 as
    register ops x_k = op(x_k, x_{k + s/32}), then the shuffle levels
    s = 16 .. 1 in register 0; the total every thread takes from lane 0."""
    regs = _regs(x)
    h = len(regs) // 2
    while h > 0:
        for k in range(h):
            regs[k] = op(regs[k], regs[k + h])
        h //= 2
    v = regs[0]
    for s in (16, 8, 4, 2, 1):
        v = op(v, _down(v, s))
    return v[:, :1]


def _warp_scan_add(regs, h_end=None):
    """``warp_scan_add`` in place on a warp's registers: the levels
    s <= 16 with one rotation shuffle per register, k descending (a thread
    with t < s takes register k - 1 of thread t - s + 32, or 0 in register
    0); then the levels s = 32 h, h < ``h_end`` (all by default), as
    x_k += x_{k - h}, k descending (0 below)."""
    v = len(regs)
    t = torch.arange(LANES)
    for s in (1, 2, 4, 8, 16):
        for k in reversed(range(v)):
            prev = regs[k - 1] if k > 0 else torch.zeros_like(regs[k])
            got = _shfl(torch.where(t + s < LANES, regs[k], prev),
                        (t - s) % LANES)
            regs[k] = regs[k] + torch.where((t >= s) | (k > 0), got, 0.0)
    h = 1
    while h < (v if h_end is None else h_end):
        for k in reversed(range(v)):
            regs[k] = regs[k] + (regs[k - h] if k >= h else 0.0)
        h *= 2


def _warp_running_max(regs, before):
    """``warp_running_max`` in place: each register's warp prefix max, and
    ``before`` with the maxima of the registers before it."""
    t = torch.arange(LANES)
    for k in range(len(regs)):
        run = regs[k]
        for s in (1, 2, 4, 8, 16):
            run = torch.where(t >= s, _nan_max(run, _up(run, s)), run)
        regs[k] = _nan_max(run, before)
        before = _nan_max(before, _shfl(run, torch.full_like(t, 31)))


def model_warp_cdf(w, with_max=True):
    """``warp_cdf`` on rows ``w [R, 32 V]``: the add pass, then the running
    max from 0."""
    regs = _regs(w)
    _warp_scan_add(regs)
    if with_max:
        _warp_running_max(regs, torch.zeros_like(regs[0]))
    return torch.stack(regs, dim=1).reshape(w.shape)


# The team form (``resample.cu::fused_resample_team``): W warps a row of
# 128 W lanes, 4 registers a thread, warp w holding lanes 128 w .. + 127.
TEAM_W = [2, 4, 8]


def _team_regs(x, w):
    """Warp ``w``'s registers of rows ``x [R, 128 W]``."""
    return _regs(x[:, 128 * w:128 * (w + 1)])


def model_team_tree(x, op):
    """``team_tree``: every warp's lanes exchanged; each thread runs the
    levels above one warp's span over the W values of each of its 4
    positions (lower index first), then ``warp_tree``'s levels."""
    nwarps = x.shape[1] // 128
    y = []
    for k in range(4):
        z = [_team_regs(x, w)[k] for w in range(nwarps)]
        h = nwarps // 2
        while h > 0:
            for v in range(h):
                z[v] = op(z[v], z[v + h])
            h //= 2
        y.append(z[0])
    return model_warp_tree(torch.stack(y, dim=1).reshape(x.shape[0], -1), op)


def model_team_cdf(w, with_max=True):
    """The team's CDF: each warp runs the in-warp levels (s <= 64) over the
    previous warp's raw registers and its own (``warp_scan_add<8, 4>``,
    the previous warp's carry 0); then, exchanged, a doubling scan over
    the W warps at each position; each warp's running max starts from the
    max over the warps before it (a butterfly over its threads)."""
    nwarps = w.shape[1] // 128
    t = torch.arange(LANES)
    z = []
    for v in range(nwarps):
        prev = (_team_regs(w, v - 1) if v > 0
                else [torch.zeros_like(w[:, :LANES])] * 4)
        regs = prev + _team_regs(w, v)
        _warp_scan_add(regs, h_end=4)
        z.append(regs[4:])
    d = 1
    while d < nwarps:
        for v in reversed(range(nwarps)):
            z[v] = [z[v][k] + (z[v - d][k] if v >= d else 0.0)
                    for k in range(4)]
        d *= 2
    if with_max:
        for v in reversed(range(nwarps)):
            before = torch.zeros_like(z[v][0])
            for u in range(v):
                for k in range(4):
                    before = _nan_max(before, z[u][k])
            for q in (16, 8, 4, 2, 1):
                before = _nan_max(before, _shfl(before, t ^ q))
            _warp_running_max(z[v], before)
    return torch.cat([torch.stack(r, dim=1).reshape(w.shape[0], -1)
                      for r in z], dim=1)


def model_search_slots(cdf, pos):
    """``search_slots``: every slot's halving search over ``cdf [R, n]``
    run a step at a time, all slots together (the steps are the bit length
    of n); ``!(cdf[mid] > pos)`` moves right, so NaN compares as
    ``searchsorted`` compares it; clamped to n - 1."""
    n = cdf.shape[1]
    lo = torch.zeros(pos.shape, dtype=torch.int64)
    hi = torch.full(pos.shape, n, dtype=torch.int64)
    for _ in range(n.bit_length()):
        act = lo < hi
        mid = lo + ((hi - lo) >> 1)
        right = ~(torch.gather(cdf, 1, mid.clamp(max=n - 1)) > pos)
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    return lo.clamp(max=n - 1)


@pytest.mark.parametrize("v", WARP_V)
def test_warp_tree_matches_the_halving_tree(v):
    n = LANES * v
    x = _rows(n, signed=True)
    assert torch.equal(_bits(model_warp_tree(x, torch.add)),
                       _bits(tree_sum(x)))
    want, m = x, n
    while m > 1:
        m //= 2
        want = _nan_max(want[:, :m], want[:, m:])
    assert torch.equal(_bits(model_warp_tree(x, _nan_max)), _bits(want))


@pytest.mark.parametrize("v", WARP_V)
def test_warp_cdf_add_pass_matches_the_doubling_order(v):
    w = _rows(LANES * v, signed=True)
    assert torch.equal(_bits(model_warp_cdf(w, with_max=False)),
                       _bits(_plain_add_pass(w)))


@pytest.mark.parametrize("v", WARP_V)
def test_warp_cdf_selects_as_the_plain_version(v):
    n = LANES * v
    w = _rows(n, signed=False)
    got, want = model_warp_cdf(w), running_cdf(w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])           # -0 == +0
    lane = torch.arange(n, dtype=torch.float32)[None, :]
    alive = torch.tensor([[n], [n - 3], [max(n // 2, 1)], [n], [n], [n],
                          [n], [n - 1]], dtype=torch.float32)
    ext_got = torch.where(lane >= alive - 1.0, 1.5, got)
    ext_want = torch.where(lane >= alive - 1.0, 1.5, want)
    pos = torch.rand((8, n), generator=torch.Generator().manual_seed(v))
    pos[:, :4] = torch.tensor([0.0, 1e-40, 0.5, 1.0])
    assert torch.equal(model_search_slots(ext_got, pos),
                       select_index(ext_want, pos))


@pytest.mark.parametrize("nwarps", TEAM_W)
def test_team_tree_matches_the_halving_tree(nwarps):
    n = 128 * nwarps
    x = _rows(n, signed=True)
    assert torch.equal(_bits(model_team_tree(x, torch.add)),
                       _bits(tree_sum(x)))
    want, m = x, n
    while m > 1:
        m //= 2
        want = _nan_max(want[:, :m], want[:, m:])
    assert torch.equal(_bits(model_team_tree(x, _nan_max)), _bits(want))


@pytest.mark.parametrize("nwarps", TEAM_W)
def test_team_cdf_add_pass_matches_the_doubling_order(nwarps):
    w = _rows(128 * nwarps, signed=True)
    assert torch.equal(_bits(model_team_cdf(w, with_max=False)),
                       _bits(_plain_add_pass(w)))


@pytest.mark.parametrize("nwarps", TEAM_W)
def test_team_cdf_selects_as_the_plain_version(nwarps):
    n = 128 * nwarps
    w = _rows(n, signed=False)
    got, want = model_team_cdf(w), running_cdf(w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    lane = torch.arange(n, dtype=torch.float32)[None, :]
    alive = torch.tensor([[n], [n - 3], [n // 2], [n], [n], [n], [n],
                          [n - 1]], dtype=torch.float32)
    pos = torch.rand((8, n), generator=torch.Generator().manual_seed(n))
    pos[:, :4] = torch.tensor([0.0, 1e-40, 0.5, 1.0])
    assert torch.equal(
        model_search_slots(torch.where(lane >= alive - 1.0, 1.5, got), pos),
        select_index(torch.where(lane >= alive - 1.0, 1.5, want), pos))


@pytest.mark.parametrize("n", [1, 20, 33, 100, 128, 1000])
def test_search_slots_is_searchsorted(n):
    """The kernels' search against ``torch.searchsorted(right=True)`` on
    sorted CDFs with ties, NaN-prefixed and NaN-holed ones, unsorted ones,
    and positions at 0, -0, 1.5, inf and NaN."""
    gen = torch.Generator().manual_seed(n)
    w = torch.rand((6, n), generator=gen)
    w = torch.where(torch.rand((6, n), generator=gen) < 0.3, 0.0, w)
    cdf = running_cdf(w / w.sum(dim=1, keepdim=True).clamp(min=1e-30))
    cdf[1, : n // 2] = float("nan")                 # an all-NaN chain's
    cdf[1, n // 2:] = 1.5
    cdf[2, n // 3] = float("nan")
    cdf[3] = torch.rand(n, generator=gen)           # unsorted
    cdf[4, -1] = 1.5
    pos = torch.rand((6, n), generator=gen).sort(dim=1).values
    pos[5] = pos[5][torch.randperm(n, generator=gen)]
    special = torch.tensor([0.0, -0.0, 1.5, float("inf"), float("nan")])
    k = min(n, len(special))
    pos[:, :k] = special[:k]
    pos[0, -1] = float("nan")
    assert torch.equal(model_search_slots(cdf, pos), select_index(cdf, pos))


def _kept_case(seed, n=100, c=6, d=3):
    gen = torch.Generator().manual_seed(seed)
    lw = torch.randn((c, n), generator=gen) * torch.tensor(
        [[0.01], [0.1], [3.0], [0.05], [5.0], [0.2]])
    lw[3, 7] = float("nan")                         # ess NaN: kept
    parts = torch.randn((c, n, d), generator=gen)
    uni = torch.full((c, n), 1.0 / n)
    return lw, parts, uni


@pytest.mark.parametrize("route", ["host", "inkernel"])
def test_kept_chains_ignore_positions(route):
    """What the kernel's skip rests on: with ``always_resample=False`` a
    chain whose ``ess >= threshold`` (or NaN) returns the same particles,
    weights, ESS and log-sum-exp whatever positions it is given, NaN ones
    included, so the kernel need not build its CDF, draw or search."""
    lw, parts, uni = _kept_case(41)
    c, n = lw.shape
    thr = torch.full((c,), 0.5 * n)
    gen = torch.Generator().manual_seed(42)
    if route == "host":
        pos_sets = [dict(positions=torch.rand((c, n), generator=gen)),
                    dict(positions=torch.full((c, n), float("nan"))),
                    dict(positions=-torch.rand((c, n), generator=gen))]
    else:
        alive = torch.full((c,), float(n))
        pos_sets = [dict(key_words=torch.randint(0, 2**32, (c, 2),
                                                 generator=gen),
                         num_alive=alive, method=m)
                    for m in ("stratified", "systematic", "multinomial")]
        pos_sets.append(dict(key_words=pos_sets[0]["key_words"],
                             num_alive=torch.full((c,), float("nan")),
                             method="stratified"))
    outs = [fused_weight_resample_reference(lw, parts, uni, thr, **kw)
            for kw in pos_sets]
    ess = outs[0][2]
    kept = ~(ess < thr)
    assert bool(kept.any()) and bool((~kept).any())
    assert bool(torch.isnan(ess[3]))
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            a, b = a[kept], b[kept]
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(_bits(a[~torch.isnan(a)]),
                               _bits(b[~torch.isnan(b)]))
    # A kept chain returns its own particles and its normalised weights.
    assert torch.equal(outs[0][0][kept], parts[kept])
