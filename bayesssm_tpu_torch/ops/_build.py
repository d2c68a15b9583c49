"""Build, load and launch the port's CUDA kernels (``csrc/``).

At first use the sources are compiled by ``nvcc`` into one shared library
with a plain C interface, ``build/bayesssm_tpu_torch/libbssm_sweep_<hash>
.so`` at the checkout's root (the hash covers sources and flags), and
loaded with ``ctypes``. Nothing here is imported or built when the module
is imported, and nothing runs on CPU tensors: the launchers raise unless
every tensor lies on one CUDA device.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` (the Gillespie
step relies on IEEE inf/NaN staying behind its ``fire`` gate, and the
kernel's ``logf``/``log1pf``/``expf``/``cosf`` must be the accurate ones
PyTorch's CUDA ops call), and ``--fmad=false`` so that no multiply-add is
contracted: PyTorch evaluates each elementwise op with its own rounding,
and the kernel is held to that plain version chain by chain.

Every launcher adds one to ``launches[entry]`` when it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = ["NVCC_FLAGS", "launches", "reset_launches", "load_library",
           "build_info", "launch_sweep", "launch_select"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "bayesssm_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Model constants of each sweep entry, after the shared arguments.
_SWEEP_CONSTS = {
    "bssm_sweep_sir": (_F, _F, _F, _I),    # inv_nt, s0, i0, unroll
    "bssm_sweep_lgss": (_F, _F),           # c, p0
}
_SWEEP_SHARED = (_P,) * 7 + (_I,) * 5      # 7 pointers, C N T mode syst

launches = {name: 0 for name in (*_SWEEP_CONSTS, "bssm_select")}
build_info: dict = {}
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    out = _BUILD_DIR / f"libbssm_sweep_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, consts in _SWEEP_CONSTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [*_SWEEP_SHARED, *consts, _P]
        fn.restype = _I
    lib.bssm_select.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.bssm_select.restype = _I
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas=log)
    _lib = lib
    return lib


def _check(tensors: dict, device: torch.device) -> None:
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} must be on {device} (got {t.device})")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_sweep(kernel, words, ys, theta, alive, thr, n, *, d, mode,
                 systematic):
    """Launch ``kernel.entry`` for ``C`` chains of ``n`` lanes.

    Returns ``(loglike [C], state_est [C, T+1, d])``.
    """
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError("launch_sweep takes CUDA tensors only")
    c, p = theta.shape
    t = ys.shape[0]
    seeds = torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).contiguous()
    _check({"seed_words": (seeds, torch.int32), "y": (ys, torch.float32),
            "theta": (theta, torch.float32), "alive": (alive, torch.float32),
            "threshold": (thr, torch.float32)}, dev)
    if seeds.shape != (c, 2) or alive.shape != (c,) or thr.shape != (c,):
        raise ValueError("seed_words, alive and threshold must cover C chains")
    if n < 128 or n > 1024 or n & (n - 1):
        raise ValueError("the sweep kernel takes 128..1024 lanes, a power "
                         "of two")
    ll = torch.empty(c, dtype=torch.float32, device=dev)
    est = torch.empty((c, t + 1, d), dtype=torch.float32, device=dev)
    lib = load_library()
    rc = getattr(lib, kernel.entry)(
        seeds.data_ptr(), ys.data_ptr(), theta.data_ptr(), alive.data_ptr(),
        thr.data_ptr(), ll.data_ptr(), est.data_ptr(), c, n, t, int(mode),
        int(bool(systematic)), *kernel.consts, _stream(dev),
    )
    _raise_on(rc, kernel.entry)
    launches[kernel.entry] += 1
    return ll, est


def launch_select(cdf_ext, pos, cols):
    """Launch ``bssm_select``: ``cols[j][m_k]`` for ``[R, N]`` inputs."""
    dev = cdf_ext.device
    if dev.type != "cuda":
        raise ValueError("launch_select takes CUDA tensors only")
    r, n = cdf_ext.shape
    if n < 1 or n > 1024:
        raise ValueError("bssm_select takes 1..1024 lanes per row")
    vals = torch.stack([c for c in cols]).contiguous()
    _check({"cdf_ext": (cdf_ext, torch.float32), "pos": (pos, torch.float32),
            "cols": (vals, torch.float32)}, dev)
    if pos.shape != (r, n) or vals.shape[1:] != (r, n):
        raise ValueError("cdf_ext, pos and every column must be [R, N]")
    out = torch.empty_like(vals)
    lib = load_library()
    rc = lib.bssm_select(cdf_ext.data_ptr(), pos.data_ptr(), vals.data_ptr(),
                         out.data_ptr(), r, n, vals.shape[0], _stream(dev))
    _raise_on(rc, "bssm_select")
    launches["bssm_select"] += 1
    return tuple(out.unbind(0))
