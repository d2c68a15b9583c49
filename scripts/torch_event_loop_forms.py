#!/usr/bin/env python3
"""Forms of the SIR event loop of the port's Hopper kernels, side by side
on one NVIDIA GPU.

Run from the root of a checkout: ``python3
scripts/torch_event_loop_forms.py``. Every form runs the attempts of
``csrc/models.cuh::sir_lane``, so each must equal its plain version bit
for bit; they differ in how lanes map to threads and how far ahead a lane
draws:

* K1 with the SIR functor at ``chip_smoke.py`` phase 5's inputs (4096 x
  128 x 10, BPF): ``lane`` is the library's kernel, whose lanes compute
  each attempt's draws just before its serial steps; ``lane_here`` is the
  same functor built in this script's unit (launched as the other forms
  are); ``lane_g2`` and ``lane_g4`` compute the draws of 2 and 4 attempts
  ahead. ms by CUDA-graph replay with the counts on the card, as phase 5
  times (and by CUDA events), each form twice in turn.
* K4 (the Gillespie day-step): ``flat`` is the library's kernel
  (``csrc/gillespie.cu``): one thread a lane over a flat grid, so a warp
  runs until its own slowest lane is done; ``flat_g2``, ``flat_g4`` and
  ``flat_g8`` draw 2, 4 and 8 attempts ahead. ``queue_w<W>_r<R>`` is a persistent
  grid (W warps resident on each SM) whose threads take the next lane from
  a counter in device memory when theirs ends: a warp refills its idle
  threads together, with one ``atomicAdd``, once R of its 32 lanes are
  idle, so a warp costs about the sum of its lanes' attempts rather than
  32 times their maximum. ``pair`` runs two lanes a thread, their attempts
  interleaved. Inputs: phase 8's states (4096 x 128 and 4096 x 1024) and
  two days of the states the engine path hands K4
  (``chip_smoke.engine_day_states``); ms by CUDA-graph replay
  (``graph_ms``).

Prints the card's name and power limit, the registers of the script's
kernels and the library's occupancy, and one ``[k1_forms]`` or
``[k4_forms]`` line per form and input. Fails without a CUDA device or
when a form differs from its plain version.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {
using namespace bssm;

constexpr int kQueueThreads = 256;
constexpr int kPairThreads = 128;

// One lane's run: its stream, state, clock, rates and attempts so far.
struct LaneRun {
  Rng rng;
  float s, i, tloc, lam_n, gam;
  int a;
};

// Loads lane g; a lane with I = 0 is written back at once and not run.
__device__ __forceinline__ bool begin(LaneRun& r, int g, int n,
                                      const int* seeds, const float* state,
                                      const float* lam, const float* gam,
                                      float* out, float inv_nt) {
  const int c = g / n, l = g - c * n;
  r.rng.key = lane_key((uint32_t)seeds[2 * c], (uint32_t)seeds[2 * c + 1],
                       (uint32_t)l);
  r.rng.ctr = 0;
  r.s = state[2 * (size_t)g];
  r.i = state[2 * (size_t)g + 1];
  r.tloc = 0.0f;
  r.a = 0;
  r.lam_n = lam[c] * inv_nt;
  r.gam = gam[c];
  if (r.i > 0.0f) return true;
  out[2 * (size_t)g] = r.s;
  out[2 * (size_t)g + 1] = r.i;
  return false;
}

// One attempt; writes the lane back when it ends.
__device__ __forceinline__ bool step(LaneRun& r, int g, float* out,
                                     float t_end, int cap) {
  const bool go = sir_event(-log1pf(-r.rng.uniform_at(2 * r.a)),
                            r.rng.uniform_at(2 * r.a + 1), r.s, r.i,
                            r.tloc, r.lam_n, r.gam, t_end) &&
                  ++r.a < cap;
  if (!go) {
    out[2 * (size_t)g] = r.s;
    out[2 * (size_t)g + 1] = r.i;
  }
  return go;
}

__global__ void __launch_bounds__(kQueueThreads)
    k4_queue(const int* seeds, const float* state, const float* lam,
             const float* gam, float* out, int* next, int total, int n,
             float inv_nt, float t_end, int cap, int refill) {
  const int t = threadIdx.x & 31;
  const int first = gridDim.x * kQueueThreads;
  int g = blockIdx.x * kQueueThreads + threadIdx.x;
  LaneRun r;
  bool running =
      g < total && begin(r, g, n, seeds, state, lam, gam, out, inv_nt);
  bool drained = first >= total;
  for (;;) {
    if (running) running = step(r, g, out, t_end, cap);
    const unsigned idle = __ballot_sync(kAllLanes, !running);
    if (drained) {
      if (idle == kAllLanes) break;
      continue;
    }
    const int want = __popc(idle);
    if (want < refill) continue;
    int base = 0;
    if (t == 0) base = atomicAdd(next, want);
    base = __shfl_sync(kAllLanes, base, 0);
    if ((idle >> t) & 1u) {
      g = first + base + __popc(idle & ((1u << t) - 1u));
      running =
          g < total && begin(r, g, n, seeds, state, lam, gam, out, inv_nt);
    }
    drained = first + base + want >= total;
  }
}

__global__ void __launch_bounds__(kPairThreads)
    k4_pair(const int* seeds, const float* state, const float* lam,
            const float* gam, float* out, int total, int n, float inv_nt,
            float t_end, int cap) {
  const int half = (total + 1) / 2;
  const int g0 = blockIdx.x * kPairThreads + threadIdx.x;
  if (g0 >= half) return;
  const int g1 = g0 + half;
  LaneRun r0, r1;
  bool run0 = begin(r0, g0, n, seeds, state, lam, gam, out, inv_nt);
  bool run1 =
      g1 < total && begin(r1, g1, n, seeds, state, lam, gam, out, inv_nt);
  while (run0 || run1) {
    if (run0) run0 = step(r0, g0, out, t_end, cap);
    if (run1) run1 = step(r1, g1, out, t_end, cap);
  }
}

// sir_lane with the draws of G attempts computed ahead of their serial
// rate -> divide -> compare steps (the library's sir_lane draws one at a
// time); draws past the lane's last attempt go unused.
template <int G>
__device__ __forceinline__ int lane_grouped(const Rng& rng, int ctr0,
                                            float& s, float& i, float lam_n,
                                            float gam, float t_end,
                                            int cap) {
  float tloc = 0.0f;
  bool active = i > 0.0f;
  int a = 0;
  while (active && a < cap) {
    float neg_log[G], u1[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      neg_log[e] = -log1pf(-rng.uniform_at(ctr0 + 2 * (a + e)));
      u1[e] = rng.uniform_at(ctr0 + 2 * (a + e) + 1);
    }
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if (active && a < cap) {
        active = sir_event(neg_log[e], u1[e], s, i, tloc, lam_n, gam, t_end);
        ++a;
      }
    }
  }
  return a;
}

template <int G>
__global__ void __launch_bounds__(kPairThreads)
    k4_grouped(const int* seeds, const float* state, const float* lam,
               const float* gam, float* out, int total, int n, float inv_nt,
               float t_end, int cap) {
  const int g = blockIdx.x * kPairThreads + threadIdx.x;
  if (g >= total) return;
  const int c = g / n, l = g - c * n;
  Rng rng;
  rng.key = lane_key((uint32_t)seeds[2 * c], (uint32_t)seeds[2 * c + 1],
                     (uint32_t)l);
  rng.ctr = 0;
  float s = state[2 * (size_t)g], i = state[2 * (size_t)g + 1];
  lane_grouped<G>(rng, 0, s, i, lam[c] * inv_nt, gam[c], t_end, cap);
  out[2 * (size_t)g] = s;
  out[2 * (size_t)g + 1] = i;
}

// K1's SIR functor with the grouped lane loop.
template <int G>
struct SirGrouped : SirModel {
  __device__ void transition(Rng& rng, float st[D], const float* th,
                             int) const {
    const int a = lane_grouped<G>(rng, rng.ctr, st[0], st[1],
                                  th[0] * inv_nt, th[1], 1.0f,
                                  event_cap(unroll));
    rng.ctr += 2 * unroll * block_max_int((a + unroll - 1) / unroll);
  }
};

}  // namespace

extern "C" {

int k1_sir_grouped(const int* seeds, const float* y, const float* theta,
                   const float* alive, const float* thr, float* ll,
                   float* est, const int* gaps, const int* times, int C,
                   int N, int T, int mode, int systematic, int algorithm,
                   float inv_nt, float s0, float i0, int unroll,
                   int move_step_max, int group, void* stream) {
  const SirModel base{inv_nt, s0, i0, unroll, move_step_max};
  const cudaStream_t st = (cudaStream_t)stream;
  if (group == 1) {  // the library's functor, built in this unit
    return launch_sweep(base, seeds, y, theta, alive, thr, ll, est, gaps,
                        times, C, N, T, mode, systematic, algorithm, st);
  }
  if (group == 2) {
    return launch_sweep(SirGrouped<2>{base}, seeds, y, theta, alive, thr,
                        ll, est, gaps, times, C, N, T, mode, systematic,
                        algorithm, st);
  }
  return launch_sweep(SirGrouped<4>{base}, seeds, y, theta, alive, thr, ll,
                      est, gaps, times, C, N, T, mode, systematic,
                      algorithm, st);
}

int k4_grouped_launch(const int* seeds, const float* state, const float* lam,
                      const float* gam, float* out, int C, int N,
                      float inv_nt, float t_end, int unroll, int group,
                      void* stream) {
  const int total = C * N;
  const int blocks = (total + kPairThreads - 1) / kPairThreads;
  auto* kernel = group == 2   ? k4_grouped<2>
                 : group == 4 ? k4_grouped<4>
                              : k4_grouped<8>;
  kernel<<<blocks, kPairThreads, 0, (cudaStream_t)stream>>>(
      seeds, state, lam, gam, out, total, N, inv_nt, t_end,
      event_cap(unroll));
  return (int)cudaGetLastError();
}

int k4_queue_launch(const int* seeds, const float* state, const float* lam,
                    const float* gam, float* out, int* next, int C, int N,
                    float inv_nt, float t_end, int unroll, int warps_per_sm,
                    int refill, void* stream) {
  // Asked once, on the first (uncaptured) call.
  static int sms = 0, occ = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k4_queue,
                                                  kQueueThreads, 0);
  }
  int per_sm = warps_per_sm * 32 / kQueueThreads;
  if (per_sm > occ) per_sm = occ;
  if (per_sm < 1) per_sm = 1;
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  k4_queue<<<sms * per_sm, kQueueThreads, 0, (cudaStream_t)stream>>>(
      seeds, state, lam, gam, out, next, C * N, N, inv_nt, t_end,
      event_cap(unroll), refill);
  return (int)cudaGetLastError();
}

int k4_pair_launch(const int* seeds, const float* state, const float* lam,
                   const float* gam, float* out, int C, int N, float inv_nt,
                   float t_end, int unroll, void* stream) {
  const int half = (C * N + 1) / 2;
  k4_pair<<<(half + kPairThreads - 1) / kPairThreads, kPairThreads, 0,
            (cudaStream_t)stream>>>(seeds, state, lam, gam, out, C * N, N,
                                    inv_nt, t_end, event_cap(unroll));
  return (int)cudaGetLastError();
}

int k4_forms_info(int* regs) {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, k4_queue);
  regs[0] = attr.numRegs;
  cudaFuncGetAttributes(&attr, k4_pair);
  regs[1] = attr.numRegs;
  return (int)cudaGetLastError();
}

}  // extern "C"
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load():
    from bayesssm_tpu_torch.ops import _build

    lib = _build._build_unit(SOURCE, _build._unit_digest(SOURCE))
    lib.k4_queue_launch.argtypes = [_P] * 6 + [_I] * 2 + [_F] * 2 + [_I] * 3 \
        + [_P]
    lib.k4_pair_launch.argtypes = [_P] * 5 + [_I] * 2 + [_F] * 2 + [_I, _P]
    lib.k4_grouped_launch.argtypes = [_P] * 5 + [_I] * 2 + [_F] * 2 \
        + [_I] * 2 + [_P]
    lib.k1_sir_grouped.argtypes = [_P] * 9 + [_I] * 6 + [_F] * 3 \
        + [_I] * 3 + [_P]
    lib.k4_forms_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.k4_queue_launch, lib.k4_pair_launch,
               lib.k4_grouped_launch, lib.k1_sir_grouped,
               lib.k4_forms_info):
        fn.restype = _I
    return lib


def forms(lib, words, state, lam, gam):
    """``{name: fn()}`` launching each form on one input (500 people,
    t_end = 1, unroll = 8, as the engine calls K4)."""
    import numpy as np

    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.gillespie import gillespie_step

    c, n, _ = state.shape
    seeds = _build._seeds_i32(words)
    inv_nt = float(np.float32(1.0 / 500))
    dev = state.device

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def queue(warps_per_sm, refill):
        def run():
            out = torch.empty_like(state)
            nxt = torch.empty(1, dtype=torch.int32, device=dev)
            _build._raise_on(lib.k4_queue_launch(
                seeds.data_ptr(), state.data_ptr(), lam.data_ptr(),
                gam.data_ptr(), out.data_ptr(), nxt.data_ptr(), c, n, inv_nt,
                1.0, 8, warps_per_sm, refill, stream()), "k4_queue")
            return out
        return run

    def pair():
        out = torch.empty_like(state)
        _build._raise_on(lib.k4_pair_launch(
            seeds.data_ptr(), state.data_ptr(), lam.data_ptr(),
            gam.data_ptr(), out.data_ptr(), c, n, inv_nt, 1.0, 8, stream()),
            "k4_pair")
        return out

    def grouped(group):
        def run():
            out = torch.empty_like(state)
            _build._raise_on(lib.k4_grouped_launch(
                seeds.data_ptr(), state.data_ptr(), lam.data_ptr(),
                gam.data_ptr(), out.data_ptr(), c, n, inv_nt, 1.0, 8, group,
                stream()), "k4_grouped")
            return out
        return run

    out = {"flat": lambda: gillespie_step(words, state, lam, gam, 500),
           "pair": pair}
    for group in (2, 4, 8):
        out[f"flat_g{group}"] = grouped(group)
    for warps in (16, 32, 64):
        for refill in (8, 16):
            out[f"queue_w{warps}_r{refill}"] = queue(warps, refill)
    return out


def k1_forms(lib, cs, dev):
    """K1 with the SIR functor at phase 5's inputs (4096 x 128 x 10, BPF):
    the library's lane loop and the grouped ones, each bitwise with the
    plain sweep; ms by CUDA events over 10 launches, as phase 5 times."""
    import numpy as np

    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.sweep_builder import _ALGORITHM, _MODE

    _, op, y2 = cs.sir_inputs(dev)
    rng = np.random.default_rng(5)
    base = np.array([0.5, 0.2], np.float32)
    theta = torch.as_tensor(
        base * np.exp(0.1 * rng.normal(size=(cs.CHAINS, 2))).astype(
            np.float32), device=dev)
    words = cs.words_for(cs.CHAINS, 1, dev)
    n = cs.PARTICLES
    w, ys, th, alive, thr, _ = op._prepare(words, y2, theta, n, n, None)
    seeds = _build._seeds_i32(w)
    c, t = th.shape[0], ys.shape[0]

    def grouped(group):
        def run():
            ll = torch.empty(c, device=dev)
            est = torch.empty((c, t + 1, 2), device=dev)
            _build._raise_on(lib.k1_sir_grouped(
                seeds.data_ptr(), ys.data_ptr(), th.data_ptr(),
                alive.data_ptr(), thr.data_ptr(), ll.data_ptr(),
                est.data_ptr(), None, None, c, n, t, _MODE[op.mode],
                int(op.method == "systematic"), _ALGORITHM[op.algorithm],
                *op.kernel.consts, group,
                torch.cuda.current_stream(dev).cuda_stream), "k1_grouped")
            return ll, est
        return run

    want = op.sweep_reference(words, y2, theta, n, max_particles=n)
    runs = {"lane": lambda: op(words, y2, theta, alive, max_particles=n),
            "lane_here": grouped(1),
            "lane_g2": grouped(2), "lane_g4": grouped(4)}
    # Two rounds, so that no form is only ever timed first.
    for round_ in range(2):
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            cs.say("k1_forms", round=round_, form=name, bitwise_equal=equal,
                   ms=cs.graph_ms(fn, 10), events_ms=cs.cuda_ms(fn, 10))
            if not equal:
                raise AssertionError(f"K1 {name} differs from the plain "
                                     "sweep")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_event_loop_forms: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.gillespie import gillespie_step_reference

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    lib = load()
    regs = (ctypes.c_int * 2)()
    rc = lib.k4_forms_info(regs)
    cs.say("k4_forms", queue_registers=regs[0], pair_registers=regs[1],
           rc=rc, library=cs.json.dumps(_build.occupancy()))
    k1_forms(lib, cs, dev)
    words, states, lam, gam = cs.engine_day_states(dev)
    inputs = {"phase8_128": cs.gillespie_inputs(dev, 128),
              "phase8_1024": cs.gillespie_inputs(dev, 1024),
              "engine_day3": (words[3], states[3], lam, gam),
              "engine_day7": (words[7], states[7], lam, gam)}
    for what, args in inputs.items():
        want = gillespie_step_reference(*args, 500)
        for name, fn in forms(lib, *args).items():
            got = fn()
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            ms = cs.graph_ms(fn, 20)
            cs.say("k4_forms", input=what, form=name, bitwise_equal=equal,
                   ms=ms)
            if not equal:
                raise AssertionError(f"{name} differs on {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
