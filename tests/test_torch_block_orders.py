"""The block reductions and the CDF scan of the Hopper kernels
(``csrc/reduce.cuh``), modelled in plain PyTorch, against the plain
versions' orders (``ops/sweep_builder.py``: ``tree_sum`` and
``running_cdf``).

The kernels keep the old halving tree and JAX's doubling scan but run the
levels inside a warp on shuffles and only the cross-warp levels through
shared memory, in a transposed layout. The models below follow
``block_reduce`` and ``block_cdf`` step by step, shuffle by shuffle, on
``[R, n]`` rows (one row a block). The sums must equal the plain orders
bit for bit, NaN payloads included; the running max may differ only in
which zero's sign or NaN payload it keeps, so its values (NaN where NaN)
and the selected indices must be equal. Inputs carry +-0, denormals,
+-inf and one NaN lane. No card is needed.
"""

import pytest
import torch

from bayesssm_tpu_torch.ops.merge_select import select_index
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
