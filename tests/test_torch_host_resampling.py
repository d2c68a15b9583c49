"""The port's host resampler (``bayesssm_tpu_torch/ops/host_resampling.py``,
its own copy of the C++ source built with ``g++``).

The seven tests of ``tests/test_host_resampling.py`` with their cases,
then the port's outputs against the JAX module's on the same generator
state, bit for bit, where the JAX module's library loads. The port's
tests need only its own library.
"""

import hashlib

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.ops import host_resampling
from bayesssm_tpu_torch.ops.host_resampling import (
    host_resample_multinomial,
    host_resample_stratified,
    host_resample_systematic,
    native_available,
)
from bayesssm_tpu_torch.ops.resampling import resample_indices
from bayesssm_tpu_torch.ops.threefry import key, split

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _library():
    """Build (or load) the library when a test runs, not at import."""
    if not native_available():
        pytest.skip("g++ unavailable")


FNS = {
    "multinomial": host_resample_multinomial,
    "stratified": host_resample_stratified,
    "systematic": host_resample_systematic,
}


@pytest.mark.parametrize("method", list(FNS))
def test_frequencies(method):
    w = np.array([0.1, 0.2, 0.3, 0.2, 0.2])
    rng = np.random.default_rng(1405)
    counts = np.zeros(5)
    reps = 10_000
    for _ in range(reps):
        idx = FNS[method](w, rng)
        counts += np.bincount(idx, minlength=5)
    np.testing.assert_allclose(counts / (reps * 5), w, atol=0.05)


def test_stratified_structure():
    w = np.array([0.1, 0.5, 0.1, 0.15, 0.15])
    rng = np.random.default_rng(0)
    for _ in range(100):
        idx = host_resample_stratified(w, rng)
        assert idx[1] == 1 and idx[2] == 1


def test_systematic_coupling():
    w = np.array([0.1, 0.5, 0.1, 0.15, 0.15])
    rng = np.random.default_rng(1)
    for _ in range(100):
        idx = host_resample_systematic(w, rng)
        assert idx[1] == 1 and idx[2] == 1
        if idx[0] == 0:
            assert idx[3] == 2
        elif idx[0] == 1:
            assert idx[3] == 3


@pytest.mark.parametrize("method", list(FNS))
def test_degenerate_atom(method):
    w = np.array([0.0, 0.0, 1.0, 0.0])
    idx = FNS[method](w, np.random.default_rng(2))
    np.testing.assert_array_equal(idx, np.full(4, 2))


@pytest.mark.parametrize("method", list(FNS))
def test_negative_weight_error(method):
    with pytest.raises(ValueError, match="non-negative"):
        FNS[method](np.array([0.5, -0.1, 0.6]), np.random.default_rng(0))


@pytest.mark.parametrize("method", list(FNS))
def test_zero_sum_error(method):
    with pytest.raises(ValueError, match="positive sum"):
        FNS[method](np.zeros(4), np.random.default_rng(0))


def test_matches_device_distribution():
    # The port's portable systematic resampler and the host one agree on
    # ancestor-count distributions for the same weights.
    w = np.array([0.05, 0.25, 0.4, 0.2, 0.1])
    rng = np.random.default_rng(7)
    reps = 4000
    counts_native = np.zeros(5)
    for _ in range(reps):
        counts_native += np.bincount(
            host_resample_systematic(w, rng), minlength=5
        )
    idx_dev = resample_indices(
        split(key(0), reps),
        torch.as_tensor(w, dtype=torch.float32).expand(reps, 5),
        "systematic")
    counts_dev = np.bincount(idx_dev.numpy().ravel(), minlength=5)
    np.testing.assert_allclose(
        counts_native / (reps * 5), counts_dev / (reps * 5), atol=0.02
    )


def test_library_is_named_by_the_digest_of_its_source():
    so = host_resampling.library_path()
    digest = hashlib.sha256(host_resampling._SRC.read_bytes())
    digest.update(b"-O3 -shared -fPIC -std=c++17")
    assert so.name == f"libbssm_host_{digest.hexdigest()[:16]}.so"
    assert so.parent.parts[-2:] == ("build", "bayesssm_tpu_torch")
    assert so.exists()


@pytest.mark.parametrize("method", list(FNS))
def test_equals_the_jax_module(method):
    jax_host = pytest.importorskip("bayesssm_tpu.ops.host_resampling")
    if not jax_host.native_available():
        pytest.skip("the JAX package's host library is not built")
    want_fn = getattr(jax_host, f"host_resample_{method}")
    rng = np.random.default_rng(11)
    for n in (1, 7, 128, 4096):
        w = rng.gamma(0.3, size=n)
        w[rng.random(n) < 0.2] = 0.0
        w[0] += 0.1
        seed = int(rng.integers(2**31))
        got = FNS[method](w, np.random.default_rng(seed))
        want = want_fn(w, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
