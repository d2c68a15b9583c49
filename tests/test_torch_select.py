"""Selection contract of the port (``select_cols``, the plain version of
the kernel's binary search + gather) against the JAX merge network
``merge_select_cols(resolve_carries(...))``, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.merge_select import (
    merge_select_cols,
    resolve_carries,
    xla_roll,
)
from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.merge_select import select_cols, select_index
from bayesssm_tpu_torch.ops.sweep_builder import cdf_ext

torch.set_num_threads(1)


def _case(n, seed, zero_share, systematic):
    rng = np.random.default_rng(seed)
    r = 6
    w = rng.random((r, n)).astype(np.float32)
    w[rng.random((r, n)) < zero_share] = 0.0
    alive = rng.integers(max(1, n // 3), n + 1, size=r).astype(np.float32)
    alive[0] = n
    lane = np.arange(n, dtype=np.float32)
    mask = lane[None, :] < alive[:, None]
    w[~mask] = 0.0
    w[:, 0] = np.maximum(w[:, 0], 1e-3)
    w /= w.sum(axis=1, keepdims=True)
    u = rng.random((r, n)).astype(np.float32)
    if systematic:
        u = np.repeat(u[:, :1], n, axis=1)
    pos = np.where(mask, (lane[None, :] + u) / alive[:, None], 1.0)
    cdf = cdf_ext(torch.as_tensor(w), torch.as_tensor(lane)[None, :],
                  torch.as_tensor(alive)[:, None]).numpy()
    cols = [rng.normal(size=(r, n)).astype(np.float32) for _ in range(2)]
    return cdf, pos.astype(np.float32), cols


def _jax_select(cdf, pos, cols):
    n = cdf.shape[1]
    c = jnp.asarray(cdf)
    lane = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), cdf.shape)
    vs = [jnp.asarray(v) for v in cols]
    carries = tuple(resolve_carries(c, xla_roll(v, n - 1), lane) for v in vs)
    v0s = tuple(jnp.sum(jnp.where(lane == 0, v, 0.0), axis=-1,
                        keepdims=True) for v in vs)
    out = merge_select_cols(c, jnp.asarray(pos), carries, v0s, lane)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n", [128, 256, 1024])
@pytest.mark.parametrize("zero_share,systematic",
                         [(0.0, False), (0.4, False), (0.4, True)])
def test_select_cols_matches_merge_network_bitwise(n, zero_share,
                                                   systematic):
    cdf, pos, cols = _case(n, n + int(10 * zero_share) + systematic,
                           zero_share, systematic)
    got = select_cols(torch.as_tensor(cdf), torch.as_tensor(pos),
                      [torch.as_tensor(v) for v in cols])
    for g, want in zip(got, _jax_select(cdf, pos, cols)):
        np.testing.assert_array_equal(g.numpy(), want)


def test_select_index_is_the_upper_bound_count():
    cdf = torch.tensor([[0.1, 0.1, 0.3, 0.3, 0.6, 1.5, 1.5, 1.5]])
    pos = torch.tensor([[0.0, 0.1, 0.2, 0.3, 0.59, 0.6, 1.0, 1.6]])
    want = [0, 2, 2, 4, 4, 5, 5, 7]        # 8 would be clamped to N - 1
    assert select_index(cdf, pos).tolist() == [want]


def test_cpu_tensors_never_reach_the_kernel():
    before = dict(_build.launches)
    cdf, pos, cols = _case(128, 0, 0.2, False)
    select_cols(torch.as_tensor(cdf), torch.as_tensor(pos),
                [torch.as_tensor(v) for v in cols])
    assert _build.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _build.launch_select(torch.as_tensor(cdf), torch.as_tensor(pos),
                             [torch.as_tensor(cols[0])])
