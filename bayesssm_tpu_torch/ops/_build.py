"""Build, load and launch the port's CUDA kernels (``csrc/``).

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, ``build/bayesssm_tpu_torch/libbssm_<hash>.so``
at the checkout's root (the hash covers sources and flags), loaded with
``ctypes``. Nothing here is imported or built when the module is imported,
and nothing runs on CPU tensors: the launchers raise unless every tensor
lies on one CUDA device.

Entries: ``bssm_sweep_sir``, ``bssm_sweep_lgss``, ``bssm_sweep_lgss_mv``
and ``bssm_sweep_sinusoidal`` (K1 with each model functor, ``sweep.cu``),
``bssm_fused_resample`` (K3) and ``bssm_select`` (K2 alone), both
``resample.cu``, and ``bssm_gillespie`` (K4, ``gillespie.cu``), with
``*_info`` entries that :func:`occupancy` reads. A functor generated from a user's sweep
callbacks (``ops/sweep_codegen.py``) is compiled on its own by
:func:`build_generated` into ``gen_<hash>.so`` with one entry,
``bssm_sweep_gen_<hash>``, the kernel template of ``csrc/sweep.cuh``
instantiated with it; its launches count under ``bssm_sweep_generated``.
``launch_probe`` builds and runs a generated elementwise kernel the same
way (the card's check that each traced op rounds as PyTorch's does).

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` (the Gillespie
step relies on IEEE inf/NaN staying behind its ``fire`` gate, and the
kernels' ``logf``/``log1pf``/``expf``/``cosf`` must be the accurate ones
PyTorch's CUDA ops call), and ``--fmad=false`` so that no multiply-add is
contracted: PyTorch evaluates each elementwise op with its own rounding,
and every kernel is held to its plain version bit for bit.

Every launcher adds one to ``launches[entry]`` when it launches its
kernel, and nowhere else. Counters of ``utils/timing.py``: a sweep launch
adds ``C * N * T`` to ``sweep.lane_days``; a generated unit's first use in
a process, inside the span ``load_generated``, counts ``generated.build``
when ``nvcc`` ran and ``generated.load`` when its library was already in
``build/``.
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

from bayesssm_tpu_torch.utils.timing import count, span

__all__ = ["NVCC_FLAGS", "launches", "reset_launches", "library_loaded",
           "load_library", "build_info", "occupancy", "generated_entry",
           "build_generated", "launch_probe", "launch_sweep", "launch_select",
           "launch_fused_resample", "launch_gillespie"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "bayesssm_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Model constants of each sweep entry, after the shared arguments.
_SWEEP_CONSTS = {
    # inv_nt, s0, i0, unroll, move_step_max
    "bssm_sweep_sir": (_F, _F, _F, _I, _I),
    "bssm_sweep_lgss": (_F, _F),           # c, p0
    "bssm_sweep_lgss_mv": (_F, _F, _F),    # c1, c2, p0
    "bssm_sweep_sinusoidal": (),           # no model constants
}
# seeds y theta alive thr ll est gaps times, C N T mode systematic algorithm
_SWEEP_SHARED = (_P,) * 9 + (_I,) * 6

_ENTRIES = {
    **{name: [*_SWEEP_SHARED, *consts, _P]
       for name, consts in _SWEEP_CONSTS.items()},
    "bssm_select": [_P] * 4 + [_I] * 3 + [_P],
    # lw parts pos uni thr seeds alive pout wout ess lse, C N D method
    # always, stream
    "bssm_fused_resample": [_P] * 11 + [_I] * 5 + [_P],
    # seeds state lam gam out, C N, inv_nt t_end, unroll, stream
    "bssm_gillespie": [_P] * 5 + [_I] * 2 + [_F] * 2 + [_I, _P],
}
# Registers per thread and resident blocks per SM (out pointers): K1 with
# the SIR functor at n lanes, and K4; registers and resident warps per SM
# of K3 at n lanes and d columns.
_PI = ctypes.POINTER(ctypes.c_int)
_INFO = {"bssm_sweep_sir_info": [_I, _PI, _PI],
         "bssm_gillespie_info": [_PI, _PI],
         "bssm_fused_resample_info": [_I, _I, _PI, _PI]}

# Launches of every generated functor count under one key.
GENERATED = "bssm_sweep_generated"
launches = {name: 0 for name in [*_ENTRIES, GENERATED, "bssm_op_probe"]}
build_info: dict = {}
_lib = None
_generated: dict = {}  # unit hash -> loaded library

# The translation unit of a generated functor: the functor source (a struct
# ``GenModel`` with the models.cuh interface) and one entry with the shared
# sweep arguments and no model constants.
_GEN_TEMPLATE = """// Generated by bayesssm_tpu_torch/ops/sweep_codegen.py: do not edit.
#include "sweep.cuh"

namespace bssm {{
{functor}
}}  // namespace bssm

extern "C" int {entry}(const int* seeds, const float* y, const float* theta,
                      const float* alive, const float* thr, float* ll,
                      float* est, const int* gaps, const int* times, int C,
                      int N, int T, int mode, int systematic, int algorithm,
                      void* stream) {{
  return bssm::launch_sweep(bssm::GenModel{{}}, seeds, y, theta, alive, thr,
                            ll, est, gaps, times, C, N, T, mode, systematic,
                            algorithm, (cudaStream_t)stream);
}}
"""


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


def _compile(sources, out: pathlib.Path, extra=()) -> str:
    """One ``nvcc -c`` per source, all at once, then one link."""
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for obj, proc in procs:
        text, _ = proc.communicate()
        log += text
        if proc.returncode != 0:
            failed.append(proc.returncode)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *[str(obj) for obj, _ in procs]],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{log}")
        os.replace(tmp, out)
    finally:
        for obj, _ in procs:
            obj.unlink(missing_ok=True)
    return log


def library_loaded() -> bool:
    """Whether this process has loaded the kernel library already."""
    return _lib is not None


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    out = _BUILD_DIR / f"libbssm_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = _compile([s for s in sources if s.suffix == ".cu"], out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in {**_ENTRIES, **_INFO}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas=log)
    _lib = lib
    return lib


def occupancy() -> dict:
    """Registers per thread and resident blocks per SM of K4
    (``bssm_gillespie``) and of K1 with the SIR functor
    (``bssm_sweep_sir``) at 128 and 1024 lanes, and registers and resident
    warps (chains) per SM of K3 (``bssm_fused_resample``) at 128 and 1024
    lanes of 2 columns and 1024 lanes of 3, from the CUDA runtime."""
    lib = load_library()
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    refs = (ctypes.byref(regs), ctypes.byref(blocks))
    _raise_on(lib.bssm_gillespie_info(*refs), "bssm_gillespie_info")
    out = {"bssm_gillespie": dict(registers=regs.value,
                                  blocks_per_sm=blocks.value)}
    for n in (128, 1024):
        _raise_on(lib.bssm_sweep_sir_info(n, *refs), "bssm_sweep_sir_info")
        out[f"bssm_sweep_sir@{n}"] = dict(registers=regs.value,
                                          blocks_per_sm=blocks.value)
    for n, d in ((128, 2), (1024, 2), (1024, 3)):
        _raise_on(lib.bssm_fused_resample_info(n, d, *refs),
                  "bssm_fused_resample_info")
        out[f"bssm_fused_resample@{n}x{d}"] = dict(
            registers=regs.value, warps_per_sm=blocks.value)
    return out


def _unit_digest(text: str) -> str:
    """Hex sha256 over the flags, a generated unit's text and the headers
    it may include."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(text.encode())
    return digest.hexdigest()[:16]


def generated_entry(functor: str) -> str:
    """The entry name ``bssm_sweep_gen_<hash>`` of a generated functor's
    source: the hash covers the source, the flags, the template and its
    headers, so the same callbacks always name the same library."""
    return f"bssm_sweep_gen_{_unit_digest(_GEN_TEMPLATE + functor)}"


def _build_unit(text: str, tag: str):
    """Compile (once per ``tag``) and load one generated translation unit,
    ``build/bayesssm_tpu_torch/gen_<tag>.cu``, against ``csrc/``. A failed
    ``nvcc`` raises with its log."""
    if tag in _generated:
        return _generated[tag]
    with span("load_generated"):
        out = _BUILD_DIR / f"gen_{tag}.so"
        t0 = time.perf_counter()
        log = ""
        built = not out.exists()
        if built:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = _BUILD_DIR / f"gen_{tag}.cu"
            tmp = src.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
            log = _compile([src], out, extra=("-I", str(_CSRC)))
        count("generated.build" if built else "generated.load")
        lib = ctypes.CDLL(str(out))
        build_info.setdefault("generated", {})[tag] = dict(
            path=str(out), seconds=time.perf_counter() - t0, ptxas=log)
    _generated[tag] = lib
    return lib


def build_generated(functor: str):
    """Compile (once per hash) and load the sweep entry of a generated
    functor: ``(lib, entry)``."""
    entry = generated_entry(functor)
    lib = _build_unit(_GEN_TEMPLATE.format(functor=functor, entry=entry),
                      entry.rsplit("_", 1)[1])
    fn = getattr(lib, entry)
    fn.argtypes = [*_SWEEP_SHARED, _P]
    fn.restype = _I
    return lib, entry


def launch_probe(kernel_src: str, name: str, x, n_out: int):
    """Launch a generated elementwise kernel (``sweep_codegen.probe``):
    ``extern "C" int <name>(const float* in, float* out, int rows, void*
    stream)`` over ``x [R, K]`` on a CUDA device; returns ``[R, n_out]``.
    Counted under ``bssm_op_probe``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("launch_probe takes CUDA tensors only")
    _check({"inputs": (x, torch.float32)}, dev)
    lib = _build_unit(kernel_src, _unit_digest(kernel_src))
    fn = getattr(lib, name)
    fn.argtypes = [_P, _P, _I, _P]
    fn.restype = _I
    out = torch.empty((x.shape[0], n_out), dtype=torch.float32, device=dev)
    _raise_on(fn(x.data_ptr(), out.data_ptr(), x.shape[0], _stream(dev)), name)
    launches["bssm_op_probe"] += 1
    return out


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


def _seeds_i32(words: torch.Tensor) -> torch.Tensor:
    """uint32 key words held in int64 as the int32 bit patterns."""
    return torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).contiguous()


def launch_sweep(kernel, words, ys, theta, alive, thr, n, *, d, mode,
                 systematic, algorithm=0, gap_table=None):
    """Launch ``kernel.entry`` (or, for a ``kernel.source``, the generated
    functor's entry) for ``C`` chains of ``n`` lanes; ``algorithm``
    0/1/2 is BPF/APF/RMPF, ``gap_table`` an int32 ``[2, T]`` tensor on the
    launch's device holding the per-observation transition counts and
    their running sum (``None`` for one transition a day).

    Returns ``(loglike [C], state_est [C, T+1, d])``.
    """
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError("launch_sweep takes CUDA tensors only")
    c, p = theta.shape
    t = ys.shape[0]
    seeds = _seeds_i32(words)
    _check({"seed_words": (seeds, torch.int32), "y": (ys, torch.float32),
            "theta": (theta, torch.float32), "alive": (alive, torch.float32),
            "threshold": (thr, torch.float32)}, dev)
    if seeds.shape != (c, 2) or alive.shape != (c,) or thr.shape != (c,):
        raise ValueError("seed_words, alive and threshold must cover C chains")
    if n < 128 or n > 1024 or n & (n - 1):
        raise ValueError("the sweep kernel takes 128..1024 lanes, a power "
                         "of two")
    gap_ptrs = (None, None)
    if gap_table is not None:
        _check({"gap_table": (gap_table, torch.int32)}, dev)
        gap_ptrs = (gap_table[0].data_ptr(), gap_table[1].data_ptr())
    ll = torch.empty(c, dtype=torch.float32, device=dev)
    est = torch.empty((c, t + 1, d), dtype=torch.float32, device=dev)
    if kernel.source is None:
        lib, entry, key = load_library(), kernel.entry, kernel.entry
    else:
        (lib, entry), key = build_generated(kernel.source), GENERATED
    rc = getattr(lib, entry)(
        seeds.data_ptr(), ys.data_ptr(), theta.data_ptr(), alive.data_ptr(),
        thr.data_ptr(), ll.data_ptr(), est.data_ptr(), *gap_ptrs, c, n, t,
        int(mode), int(bool(systematic)), int(algorithm), *kernel.consts,
        _stream(dev),
    )
    _raise_on(rc, entry)
    launches[key] += 1
    count("sweep.lane_days", c * n * t)
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


def launch_fused_resample(lw, parts, uni, thr, *, always, pos=None,
                          words=None, alive=None, method=-1):
    """Launch ``bssm_fused_resample`` (K3) for ``C`` chains of ``N``
    lanes: ``lw``, ``uni`` (and ``pos``) ``[C, N]``, ``parts [C, N, D]``,
    ``thr`` (and ``alive``) ``[C]``, ``words [C, 2]``. ``method`` -1 takes
    ``pos``; 0/1/2 draw stratified/systematic/multinomial positions.

    Returns ``(parts_out [C, N, D], w_out [C, N], ess [C], lse [C])``.
    """
    dev = lw.device
    if dev.type != "cuda":
        raise ValueError("launch_fused_resample takes CUDA tensors only")
    c, n = lw.shape
    if n < 1 or n > 1024:
        raise ValueError("bssm_fused_resample takes 1..1024 lanes per chain")
    if parts.ndim != 3 or parts.shape[:2] != (c, n):
        raise ValueError("particles must be [C, N, D]")
    d = parts.shape[2]
    f32 = torch.float32
    tensors = {"log_weights": (lw, f32), "particles": (parts, f32),
               "uniform_w": (uni, f32), "threshold": (thr, f32)}
    if uni.shape != (c, n) or thr.shape != (c,):
        raise ValueError("uniform_w must be [C, N] and threshold [C]")
    seeds = None
    if method == -1:
        tensors["positions"] = (pos, f32)
        if pos.shape != (c, n):
            raise ValueError("positions must be [C, N]")
    else:
        seeds = _seeds_i32(words)
        tensors.update(seed_words=(seeds, torch.int32),
                       num_alive=(alive, f32))
        if seeds.shape != (c, 2) or alive.shape != (c,):
            raise ValueError("seed words must be [C, 2] and num_alive [C]")
    _check(tensors, dev)
    pout = torch.empty_like(parts)
    wout = torch.empty_like(lw)
    ess = torch.empty(c, dtype=f32, device=dev)
    lse = torch.empty(c, dtype=f32, device=dev)
    lib = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.bssm_fused_resample(
        lw.data_ptr(), parts.data_ptr(), ptr(pos), uni.data_ptr(),
        thr.data_ptr(), ptr(seeds), ptr(alive), pout.data_ptr(),
        wout.data_ptr(), ess.data_ptr(), lse.data_ptr(), c, n, d,
        int(method), int(bool(always)), _stream(dev))
    _raise_on(rc, "bssm_fused_resample")
    launches["bssm_fused_resample"] += 1
    return pout, wout, ess, lse


def launch_gillespie(words, state, lam, gam, *, inv_nt, t_end, unroll):
    """Launch ``bssm_gillespie`` (K4): ``state [C, N, 2]`` (S, I) one day
    ahead; ``words [C, 2]``, ``lam`` and ``gam`` ``[C]``."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError("launch_gillespie takes CUDA tensors only")
    if state.ndim != 3 or state.shape[2] != 2:
        raise ValueError("state must be [C, N, 2]")
    c, n, _ = state.shape
    if n < 1 or n > 1024:
        raise ValueError("bssm_gillespie takes 1..1024 lanes per chain")
    seeds = _seeds_i32(words)
    f32 = torch.float32
    _check({"seed_words": (seeds, torch.int32), "state": (state, f32),
            "lam": (lam, f32), "gamma": (gam, f32)}, dev)
    if seeds.shape != (c, 2) or lam.shape != (c,) or gam.shape != (c,):
        raise ValueError("seed words must be [C, 2], lam and gamma [C]")
    out = torch.empty_like(state)
    lib = load_library()
    rc = lib.bssm_gillespie(seeds.data_ptr(), state.data_ptr(),
                            lam.data_ptr(), gam.data_ptr(), out.data_ptr(),
                            c, n, float(inv_nt), float(t_end), int(unroll),
                            _stream(dev))
    _raise_on(rc, "bssm_gillespie")
    launches["bssm_gillespie"] += 1
    return out
