#!/usr/bin/env python3
"""Forms of the fused weight step (K3, ``csrc/resample.cu``) and of the
standalone selection (K2) side by side on one NVIDIA GPU.

Run from the root of a checkout: ``python3 scripts/torch_k3_forms.py``.
Every form computes the plain version's orders, so each must equal
``fused_weight_resample_reference`` bit for bit; they differ in how chains
map to warps:

* ``warp_b<B>``: one warp a chain with its lanes in registers
  (``csrc/warp_reduce.cuh``), B chains a block, the particle row staged in
  shared memory by ``cp.async``; ``warp_b<B>_inplace`` gathers the
  ancestors' rows from device memory instead;
* ``team_w<W>`` (lane bounds of 256 and more): a team of W = P / 128 warps
  a chain, one chain a block, 4 lanes a thread (lane 128 w + 32 k + t); the
  tree's levels above one warp's span and the scan's cross-warp levels go
  through one shared-memory exchange each, behind a block barrier, and the
  scan's in-warp levels take the previous warp's raw values as their
  carry;
* ``library``: ``fused_weight_resample_seeded`` as the engine calls it:
  the launcher's fixed table (``resample.cu::launch_fused``).

K2's standalone entry (``bssm_select``, its value rows read in place)
takes 1, 2, 4 or 8 rows a block (``k2_forms`` lines), at phase 3's timed
shape.

Inputs (4096 chains, in-kernel stratified positions): the day step
(2 columns, adaptive at half the count) at 128, 256 and 512 lanes with
counts n/2..n, a quarter full (phase 7's at 128), and at the 1024-lane
bound with counts 50..1000 (phase 16's); the aux resample (3 columns,
forced) at 128 (phase 13's) and 1024 lanes (phase 16's). ms by CUDA-graph
replay after 1 s of untimed calls (``chip_smoke.graph_ms``).
Prints the card's name and power limit, each form's registers from
``-Xptxas -v``, and one ``[k3_forms]`` line per input and form. Fails
without a CUDA device, or when a form differs from its plain version.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# The library's two K3 forms with their choices open (the C entry takes
# them from its fixed table).
SOURCE = r"""
#include "resample.cu"

extern "C" {

int k3_warp(const float* lw, const float* parts, const float* pos,
            const float* uni, const float* thr, const long long* words,
            long long word_stride, const float* alive, float* pout,
            float* wout, float* ess, float* lse, int C, int N, int D,
            int method, int always, int wpb, int stage, void* stream) {
  bssm::FusedArgs a{};
  a.lw = lw, a.parts = parts, a.pos = pos, a.uni = uni, a.thr = thr;
  a.words = words, a.word_stride = word_stride, a.alive = alive;
  a.pout = pout, a.wout = wout, a.ess = ess, a.lse = lse;
  a.C = C, a.N = N, a.D = D, a.method = method, a.always = always;
  return (int)bssm::launch_fused_warp(a, wpb, stage != 0,
                                      (cudaStream_t)stream);
}

int k3_team(const float* lw, const float* parts, const float* pos,
            const float* uni, const float* thr, const long long* words,
            long long word_stride, const float* alive, float* pout,
            float* wout, float* ess, float* lse, int C, int N, int D,
            int method, int always, int wpb, int stage, void* stream) {
  bssm::FusedArgs a{};
  a.lw = lw, a.parts = parts, a.pos = pos, a.uni = uni, a.thr = thr;
  a.words = words, a.word_stride = word_stride, a.alive = alive;
  a.pout = pout, a.wout = wout, a.ess = ess, a.lse = lse;
  a.C = C, a.N = N, a.D = D, a.method = method, a.always = always;
  return (int)bssm::launch_fused_team(a, (cudaStream_t)stream);
}

int k2_select(const float* cdf, const float* pos, const float* vals,
              float* out, int R, int N, int D, int wpb, void* stream) {
  return (int)bssm::launch_select(cdf, pos, vals, out, R, N, D, wpb,
                                  (cudaStream_t)stream);
}

}  // extern "C"
"""


def build():
    """Compile the unit (the library's resample.cu with the team form) and
    set its entries' argument types."""
    from bayesssm_tpu_torch.ops import _build

    text = (SOURCE + "// resample.cu\n"
            + (_build._CSRC / "resample.cu").read_text())
    lib = _build._build_unit(SOURCE, _build._unit_digest(text))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("k3_warp", "k3_team"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 6 + [ctypes.c_longlong] + [p] * 5 + [i] * 7 + [p]
        fn.restype = i
    lib.k2_select.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.k2_select.restype = i
    return lib


def select_forms(lib, dev, failed):
    """K2 (``bssm_select``) at phase 3's timed shape, 4096 rows x 128
    lanes x 2 columns, sorted stratified positions: 1, 2, 4 or 8 rows a
    block, and the library's entry (its wrapper stacks the columns)."""
    import chip_smoke as cs
    from bayesssm_tpu_torch.ops.merge_select import (
        select_cols,
        select_cols_reference,
    )
    from bayesssm_tpu_torch.ops.sweep_builder import cdf_ext

    r, n = cs.CHAINS, cs.PARTICLES
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.rand((r, n), device=dev, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    lane = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    cdf = cdf_ext(w, lane, torch.full((r, 1), float(n), device=dev))
    pos = (lane + torch.rand((r, 1), device=dev, generator=gen)) / n
    cols = [torch.randn((r, n), device=dev, generator=gen) for _ in range(2)]
    vals = torch.stack(cols)
    out = torch.empty_like(vals)
    want = torch.stack(select_cols_reference(cdf, pos, cols))

    def entry(wpb):
        def call():
            rc = lib.k2_select(cdf.data_ptr(), pos.data_ptr(),
                               vals.data_ptr(), out.data_ptr(), r, n, 2, wpb,
                               torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"form failed to launch: {rc}")
            return out
        return call

    forms = {f"warp_b{b}": entry(b) for b in (1, 2, 4, 8)}
    # The card idles through the build: 3 s of calls before the first
    # timing (1 s was not enough for the first form).
    cs.cuda_ms(forms["warp_b1"], 1, warm_s=3.0)
    forms["library"] = lambda: torch.stack(select_cols(cdf, pos, cols))
    bound_ms, bound_by = cs.bound(4 * r * n * (2 + 2 * 2),
                                  (r * n, (6 * 7 + 8, 0, 0)))
    for form, fn in forms.items():
        same = torch.equal(fn(), want)
        ms = cs.graph_ms(fn, 20)
        cs.say("k2_forms", shape=f"{r}x{n}x2", form=form,
               bitwise_equal=same, kernel_ms=ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms)
        if not same:
            failed.append(f"select {form}")


def inputs(dev, n, d, aux):
    """4096 chains of ``n`` lanes: counts n/2..n, a quarter full, up to
    512 lanes, the spread 50..1000 at 1024; ``aux``: forced, threshold 0,
    the aux log-weight as the last column."""
    import chip_smoke as cs

    c = cs.CHAINS
    gen = torch.Generator(device=dev).manual_seed(13 + n)
    if n <= 512:
        alive = torch.randint(n // 2, n + 1, (c,), device=dev,
                              generator=gen).to(torch.float32)
        alive[: c // 4] = float(n)
    else:
        alive = cs.spread_counts(dev)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    lw = torch.where(live, 3.0 * torch.randn((c, n), device=dev,
                                             generator=gen), -1e30)
    parts = torch.randint(0, 200, (c, n, d - 1 if aux else d), device=dev,
                          generator=gen).to(torch.float32)
    if aux:
        parts = torch.cat([parts, lw[..., None]], dim=-1).contiguous()
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    thr = torch.zeros(c, device=dev) if aux else alive / 2.0
    words = cs.words_for(c, 31, dev)
    return lw, parts, uni, thr, words, alive


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_forms: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    dev = torch.device("cuda", 0)
    cs.say("device", kind=repr(torch.cuda.get_device_name(0)),
           nvidia_smi=repr(cs.nvidia_smi()))
    lib = build()
    for info in _build.build_info.get("generated", {}).values():
        for ln in info["ptxas"].splitlines():
            if re.search(r"registers|spill|Compiling entry", ln):
                print("[build]", ln.strip())
    for name, occ in _build.occupancy().items():
        if name.startswith("bssm_fused_resample"):
            cs.say("build", kernel=name, **occ)

    failed = []
    select_forms(lib, dev, failed)
    cases = (("day", 128, 2, False), ("aux", 128, 3, True),
             ("day", 256, 2, False), ("day", 512, 2, False),
             ("day", 1024, 2, False), ("aux", 1024, 3, True))
    for what, n, d, aux in cases:
        lw, parts, uni, thr, words, alive = inputs(dev, n, d, aux)
        want = fused_weight_resample_reference(
            lw, parts, uni, thr, key_words=words, num_alive=alive,
            method="stratified", always_resample=aux)
        outs = (torch.empty_like(parts), torch.empty_like(lw),
                torch.empty_like(thr), torch.empty_like(thr))

        def entry(fn, wpb=1, stage=1):
            def call():
                rc = fn(lw.data_ptr(), parts.data_ptr(), None,
                        uni.data_ptr(), thr.data_ptr(), words.data_ptr(),
                        words.stride(0), alive.data_ptr(),
                        *(o.data_ptr() for o in outs),
                        lw.shape[0], n, d, 0, int(aux), wpb, stage,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"form failed to launch: {rc}")
                return outs
            return call

        forms = {f"warp_b{b}": entry(lib.k3_warp, b)
                 for b in ((1, 2, 4, 8) if n <= 128 else (1, 2, 4))}
        forms["warp_b2_inplace" if n > 128 else "warp_b8_inplace"] = entry(
            lib.k3_warp, 2 if n > 128 else 8, 0)
        if n >= 256:
            forms[f"team_w{n // 128}"] = entry(lib.k3_team)
        forms["library"] = lambda: fused_weight_resample_seeded(
            lw, parts, words, alive, uni, thr, "stratified", aux)
        bound_ms, bound_by = cs.fused_resample_bound(
            lw.shape[0], n, d, float(alive.sum()))
        for form, fn in forms.items():
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = cs.graph_ms(fn, 20)
            cs.say("k3_forms", shape=f"{lw.shape[0]}x{n}x{d}", step=what,
                   form=form, bitwise_equal=same, kernel_ms=ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms)
            if not same:
                failed.append(f"{what} {n}x{d} {form}")
    if failed:
        print("torch_k3_forms: differ from the plain version: "
              + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
