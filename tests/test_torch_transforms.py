"""The port's parameter transforms (``bayesssm_tpu_torch/pmmh/transforms.py``)
with their masks built once per ``(transforms, device)``: the same bits as
the formulas evaluated with masks made afresh on every call, and no copy
from the host once a key is built (the JAX mirrors are in
``tests/test_torch_elementwise.py`` and ``tests/test_torch_mh.py``)."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.models.lgss import lgss_model
from bayesssm_tpu_torch.pmmh import transforms as tr
from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains
from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
from bayesssm_tpu_torch.utils import timing

torch.set_num_threads(1)

MIXES = list(itertools.product(tr.TRANSFORMS, repeat=3))
INF, NAN = float("inf"), float("nan")
# Per column: the clamps (1e-300 underflows to 0 in float32, 1 - 1e-15
# rounds to 1), zero, negatives, denormals, values past the logit's
# support, infinities and NaN.
THETA = [0.0, 1e-300, 1e-45, 1e-38, 1e-15, 0.25, 0.5, 1 - 1e-7, 1 - 1e-15,
         1.0, 1.5, 3e38, -1e-30, -0.5, -2.0, INF, -INF, NAN]
Z = [0.0, -1e-30, 1e-30, -3.0, 2.5, -88.0, 88.0, 88.8, -104.0, 110.0,
     -1e4, 1e4, INF, -INF, NAN]


def _fresh(transforms, like):
    """The masks as every call made them before they were cached."""
    code = torch.tensor([{"identity": 0, "log": 1, "logit": 2}[t]
                         for t in transforms], dtype=torch.int32,
                        device=like.device)
    return code == 1, code == 2


def _want_forward(theta, transforms):
    is_log, is_logit = _fresh(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    logit = torch.log(safe) - torch.log1p(-torch.clamp(theta, max=1 - 1e-15))
    return torch.where(is_logit, logit,
                       torch.where(is_log, torch.log(safe), theta))


def _want_back(z, transforms):
    is_log, is_logit = _fresh(transforms, z)
    out = torch.where(is_log, torch.exp(z), z)
    return torch.where(is_logit, 1.0 / (1.0 + torch.exp(-z)), out)


def _want_jacobian(theta, transforms, convention):
    is_log, is_logit = _fresh(transforms, theta)
    safe = torch.clamp(theta, min=1e-300)
    logit_term = torch.log(safe) + torch.log1p(
        -torch.clamp(theta, max=1 - 1e-15))
    if convention == "reference":
        logit_term = -logit_term
    return torch.where(
        is_log, torch.log(safe),
        torch.where(is_logit, logit_term, torch.zeros_like(theta)),
    ).sum(dim=-1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _grid(values, dtype):
    """``[C, 3]``: every value in every column, each row a mix."""
    col = torch.tensor(values, dtype=dtype)
    n = col.numel()
    return torch.stack([col, col.roll(n // 3), col.roll(2 * n // 3)], dim=1)


@pytest.mark.parametrize("transforms", MIXES, ids="-".join)
def test_cached_masks_give_the_bits_of_fresh_ones(transforms):
    for dtype in (torch.float32, torch.float64):
        theta, z = _grid(THETA, dtype), _grid(Z, dtype)
        # [C, P] batches and single [P] rows, each twice: the first call
        # of a key may build its masks, the second reuses them.
        for th, zz in [(theta, z)] * 2 + [(theta[4], z[5]), (theta[4], z[5])]:
            _same_bits(tr.transform_params(th, transforms),
                       _want_forward(th, transforms))
            _same_bits(tr.back_transform_params(zz, transforms),
                       _want_back(zz, transforms))
            for convention in ("consistent", "reference"):
                _same_bits(tr.log_jacobian(th, transforms, convention),
                           _want_jacobian(th, transforms, convention))


class _NoHostCopies:
    """``torch`` as the transforms module sees it, with ``tensor`` (a copy
    from host memory) refused."""

    def __getattr__(self, name):
        return getattr(torch, name)

    def tensor(self, *args, **kwargs):
        raise AssertionError("transforms.py made a host copy")


def test_a_warm_sample_chains_call_builds_nothing_and_copies_nothing(
        monkeypatch):
    _, log_priors, transform = lgss_model()
    names = list(log_priors)
    prior_fns = [log_priors[q] for q in names]
    transforms = resolve_transforms(transform, names)

    def pf(words, theta, n):
        return -(theta - 0.5).square().sum(dim=-1), None

    state = init_chain_state([0.5, 0.5, 0.5],
                             np.tile(np.eye(3, dtype=np.float32) * 0.1,
                                     (4, 1, 1)), 16, 3, "cpu")
    monkeypatch.setattr(tr, "_MASKS", {})
    timing.reset()
    warm = sample_chains(pf, state, 3, 0, prior_fns, transforms)
    assert timing.recent_calls()[-1]["counters"] == {
        "mh_steps": 2, "transform_consts.build": 1,
        "transform_consts.hit": 7}

    syncs = []
    monkeypatch.setattr(tr, "torch", _NoHostCopies())
    monkeypatch.setattr(tr, "host_sync", lambda *a, **k: syncs.append(a))
    sample_chains(pf, warm.state, 9, 0, prior_fns, transforms)
    call = timing.recent_calls()[-1]
    assert call["root"] == "sample_chains"
    assert call["counters"]["mh_steps"] == 8
    assert call["counters"].get("transform_consts.build", 0) == 0
    assert call["counters"]["transform_consts.hit"] == 32
    assert syncs == []
    timing.reset()


def test_each_transforms_tuple_and_device_builds_its_own_masks_once(
        monkeypatch):
    monkeypatch.setattr(tr, "_MASKS", {})
    timing.reset()
    theta = torch.tensor([[0.5, 0.25], [2.0, 0.75]])
    with timing.span("first"):
        a = tr.transform_params(theta, ("log", "logit"))
        tr.log_jacobian(theta, ["log", "logit"])     # a list: the same key
    with timing.span("second"):
        b = tr.transform_params(theta, ("logit", "log"))
        tr.back_transform_params(b, ("logit", "log"))
    # Another device (``meta`` stands in for a card) keeps its own entry,
    # and its build is a copy from the host, counted as a wait.
    with timing.span("meta"):
        m = tr.transform_params(theta.to("meta"), ("log", "logit"))
        tr.transform_params(theta.to("meta"), ("log", "logit"))
    first, second, meta = (c["counters"] for c in timing.recent_calls())
    assert first == {"transform_consts.build": 1, "transform_consts.hit": 1}
    assert second == {"transform_consts.build": 1, "transform_consts.hit": 1}
    assert meta == {"transform_consts.build": 1, "transform_consts.hit": 1,
                    "host_sync": 1}
    assert m.device.type == "meta"
    assert not torch.equal(a, b)
    assert set(tr._MASKS) == {
        (("log", "logit"), torch.device("cpu")),
        (("logit", "log"), torch.device("cpu")),
        (("log", "logit"), torch.device("meta")),
    }
    is_log, is_logit = tr._MASKS[(("logit", "log"), torch.device("cpu"))]
    assert is_log.tolist() == [False, True]
    assert is_logit.tolist() == [True, False]
    # An unknown name raises, as the JAX package's lookup does, and is
    # not cached.
    with pytest.raises(KeyError, match="bogus"):
        tr.transform_params(theta, ("log", "bogus"))
    assert len(tr._MASKS) == 3
    timing.reset()
