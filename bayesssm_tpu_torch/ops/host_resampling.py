"""Host-side resampling in C++ through ctypes (port of
``bayesssm_tpu/ops/host_resampling.py``).

The port's own copy of the source, ``bayesssm_tpu_torch/csrc/
host_resampling.cpp``, is built with ``g++ -O3 -shared -fPIC -std=c++17``
at first use into ``build/bayesssm_tpu_torch/libbssm_host_<digest>.so``,
named by a digest of the source and the flags (never by file times), so
an edited source builds a new library and an unchanged one is reused.

The three schemes of ``ops/resampling.py`` (multinomial, stratified,
systematic) on one weight vector, NumPy in and out: the RNG stays in
NumPy, and the C++ is a deterministic transform of the uniforms drawn
from the caller's ``np.random.Generator``, so the results equal the JAX
package's functions for the same generator state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

__all__ = [
    "host_resample_multinomial",
    "host_resample_stratified",
    "host_resample_systematic",
    "native_available",
]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host_resampling.cpp"
_BUILD_DIR = _PKG.parent / "build" / "bayesssm_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_load_error = None


def library_path() -> pathlib.Path:
    """The library this source and these flags build to."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libbssm_host_{digest.hexdigest()[:16]}.so"


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.bssm_resample_systematic.argtypes = [
                ctypes.c_int64, dp, ctypes.c_double, ip,
            ]
            lib.bssm_resample_stratified.argtypes = [
                ctypes.c_int64, dp, dp, ip,
            ]
            lib.bssm_resample_multinomial.argtypes = [
                ctypes.c_int64, dp, dp, ip,
            ]
            for f in (
                lib.bssm_resample_systematic,
                lib.bssm_resample_stratified,
                lib.bssm_resample_multinomial,
            ):
                f.restype = ctypes.c_int
            _lib = lib
        except Exception as exc:  # no g++, or the build failed
            _load_error = exc
        return _lib


def native_available() -> bool:
    """Whether the library is built (building it now if needed) and
    loaded."""
    return _load() is not None


_ERRORS = {
    1: "weights must be non-negative",
    2: "weights must have a positive sum",
}


def _check(rc: int) -> None:
    if rc != 0:
        raise ValueError(_ERRORS.get(rc, f"native resampling error {rc}"))


def _as_weights(weights) -> np.ndarray:
    w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
    if w.ndim != 1:
        raise ValueError("weights must be 1-D")
    return w


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def host_resample_systematic(weights, rng: np.random.Generator) -> np.ndarray:
    """Systematic ancestor indices (0-based int32): positions ``(j + u) /
    n`` with one ``u = rng.uniform()``."""
    lib = _library()
    w = _as_weights(weights)
    n = w.shape[0]
    out = np.empty(n, dtype=np.int32)
    rc = lib.bssm_resample_systematic(
        n,
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(rng.uniform()),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    _check(rc)
    return out


def _uniform_variant(fn_name, doc):
    def impl(weights, rng: np.random.Generator) -> np.ndarray:
        lib = _library()
        w = _as_weights(weights)
        n = w.shape[0]
        u = np.ascontiguousarray(rng.uniform(size=n))
        out = np.empty(n, dtype=np.int32)
        rc = getattr(lib, fn_name)(
            n,
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        _check(rc)
        return out

    impl.__name__ = fn_name
    impl.__doc__ = doc
    return impl


host_resample_stratified = _uniform_variant(
    "bssm_resample_stratified",
    "Stratified ancestor indices (0-based int32): positions ``(j + u_j) / "
    "n`` with ``u = rng.uniform(size=n)``.")
host_resample_multinomial = _uniform_variant(
    "bssm_resample_multinomial",
    "Multinomial ancestor indices (0-based int32): the inverse CDF at "
    "``u = rng.uniform(size=n)``.")
