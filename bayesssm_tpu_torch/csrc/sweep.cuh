// Whole-sweep particle filter for Hopper (sm_90a): bootstrap (BPF),
// auxiliary (APF) and resample-move (RMPF) days, with an optional gap loop
// for irregular observation times. The kernel template and its launcher;
// sweep.cu instantiates it with the functors of models.cuh, and each
// functor generated from a user's callbacks (ops/sweep_codegen.py) is
// instantiated in a translation unit of its own (ops/_build.py).
//
// Replaces bayesssm_tpu/ops/sweep_builder.py::_make_kernel (the Pallas TPU
// kernel of the SIR PMMH main path) together with the selection it traces
// from bayesssm_tpu/ops/merge_select.py. The plain PyTorch version is
// SweepOp.sweep_reference in bayesssm_tpu_torch/ops/sweep_builder.py.
//
// A day: the transition (gaps[t] times at times[t] - gaps[t] + s when the
// gap arrays are given); for APF the aux stage -- masked aux log-weights,
// the degenerate kill, normalised aux weights, one position draw, the CDF
// and selection, the ancestors' aux weights recomputed from the selected
// state (a copy is exact, so this equals a gather and keeps the copy
// buffer at D * N floats), the second transition (quirk Q2) and
// lw - aux_anc; then the weight step and selection; for RMPF the move.
// The chain's draw counter moves exactly as the plain sweep's does.
//
// Layout: one thread block per chain (grid = C), one thread per particle
// lane (blockDim = max_particles, a power of two in 128..1024). A thread
// keeps its particle's state in registers for all T days; y is read-only
// in global memory; shared memory holds the reduction and scan scratch of
// reduce.cuh, the CDF and the ancestor-copy buffer (SweepShared: about
// (5.1 + D) * N floats, 29 KB at N = 1024, D = 2). Lanes >= alive stay
// inert but reach every barrier.
//
// What bounds it on this card: for SIR, instruction issue for the events
// (two hashes, one log1pf and one divide each); for the event-free
// functors, a day's barriers. The design does two things about them. The
// SIR transition runs each lane's events on its own (models.cuh::
// sir_lane) with one block maximum of the lanes' event groups a
// transition for the chain's counter, so a warp issues only until its own
// slowest lane is done and a finished warp waits at one barrier. The
// reductions and the CDF scan keep the halving tree and JAX's doubling
// order (tree_sum and running_cdf reproduce their bits) but run their
// in-warp levels on shuffles (reduce.cuh): 2 barriers a reduction and 3
// for the scan, 17 a resampling BPF day of SIR at any N. One chain per
// block keeps every barrier inside a chain; the launch bound keeps a
// 1024-lane block within the register file.
//
// A functor may set kHasPack (with DP packed columns, pack(st, pk) and
// unpack(pk, st)): selection then routes the DP packed columns, unpacks
// and re-masks, as the JAX builder's pack_fn/unpack_fn do.
//
// A functor generated from callbacks that run rng.event_loop
// (ops/sweep_codegen.py) loops lane by lane as SirModel does and ends each
// loop in block_max_int, so every thread calls it, masked lanes included,
// as every functor is called here. Only such a functor adds into the
// device tally that every generated functor holds (loop_tally); the kernel
// itself is the same for all.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "models.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "select.cuh"

namespace bssm {

constexpr float kNeg = -1e30f;
constexpr float kDegenerate = -1e8f;
constexpr float kSentinel = 1.5f;
enum Mode { kAdaptive = 0, kAlways = 1, kNever = 2 };
enum Algorithm { kBpf = 0, kApf = 1, kRmpf = 2 };

// The columns selection routes: the packed ones when the functor packs.
template <class M, class = void>
struct Route {
  static constexpr bool kPack = false;
  static constexpr int kCols = M::D;
};
template <class M>
struct Route<M, std::void_t<decltype(M::kHasPack)>> {
  static constexpr bool kPack = M::kHasPack;
  static constexpr int kCols = M::kHasPack ? M::DP : M::D;
};

// The tally of a loop functor's loop (ops/sweep_codegen.py): tally[0]
// gains the lanes' own iterations `own` (one warp sum and one atomic a
// warp), tally[1] the lane-slots the block issued, its largest count `kc`
// times its lanes. Every thread of the block calls it.
__device__ __forceinline__ void loop_tally(unsigned long long* tally, int own,
                                           int kc) {
  const unsigned warp = __reduce_add_sync(kAllLanes, (unsigned)own);
  if ((threadIdx.x & 31) == 0) atomicAdd(tally, (unsigned long long)warp);
  if (threadIdx.x == 0) {
    atomicAdd(tally + 1, (unsigned long long)kc * blockDim.x);
  }
}

// One position per lane from one uniform block: stratified, or systematic
// with lane 0's draw for every slot; masked lanes get 1.0.
__device__ __forceinline__ float draw_position(Rng& rng, float lane_f,
                                               float alive, bool live,
                                               int systematic,
                                               float* u_lane0) {
  float u = rng.uniform();
  if (systematic) {
    if (threadIdx.x == 0) *u_lane0 = u;
    __syncthreads();
    u = *u_lane0;
    __syncthreads();
  }
  return live ? (lane_f + u) / alive : 1.0f;
}

// Shared memory of one block: reduction scratch, the CDF, the scan's
// scratch and the ancestor-copy buffer of `cols` columns.
struct SweepShared {
  float* red;
  float* cdf;
  float* scan;
  float* buf;
  __device__ SweepShared(float* smem, int n)
      : red(smem),
        cdf(smem + reduce_floats(n)),
        scan(cdf + n),
        buf(scan + scan_floats(n)) {}
  static size_t bytes(int n, int cols) {
    return sizeof(float) *
           (size_t)(reduce_floats(n) + n + scan_floats(n) + cols * n);
  }
};

// Ancestor selection of the block's state: slot `lane` takes the state of
// m = #{j : cdf_ext[j] <= pos} through shared memory; masked lanes get 0.
template <int D>
__device__ __forceinline__ void select_state(float w, float pos, float st[D],
                                             const SweepShared& sh, int lane,
                                             int n, float lane_f, float alive,
                                             bool live) {
  float* cdf = sh.cdf;
  float* buf = sh.buf;
  const float c = block_cdf(w, sh.scan);
  cdf[lane] = lane_f >= alive - 1.0f ? kSentinel : c;
#pragma unroll
  for (int j = 0; j < D; ++j) buf[j * n + lane] = st[j];
  __syncthreads();
  const int m = select_index(cdf, n, pos);
#pragma unroll
  for (int j = 0; j < D; ++j) st[j] = live ? buf[j * n + m] : 0.0f;
  __syncthreads();
}

// select_state on the model's state, through pack/unpack when it packs.
template <class M>
__device__ __forceinline__ void select_model(const M& model, float w,
                                             float pos, float st[M::D],
                                             const SweepShared& sh, int lane,
                                             int n, float lane_f, float alive,
                                             bool live) {
  if constexpr (Route<M>::kPack) {
    float pk[M::DP];
    model.pack(st, pk);
    select_state<M::DP>(w, pos, pk, sh, lane, n, lane_f, alive, live);
    float un[M::D];
    model.unpack(pk, un);
#pragma unroll
    for (int j = 0; j < M::D; ++j) st[j] = live ? un[j] : 0.0f;
  } else {
    select_state<M::D>(w, pos, st, sh, lane, n, lane_f, alive, live);
  }
}

// At most 1024 threads a block: the compiler keeps each instance within 64
// registers a thread, so that a 1024-lane block fits an SM's register file.
// (A minimum of one block an SM as well let ptxas give K1c 47 registers
// where it gives 32, and two of its 1024-lane blocks no longer fit an SM.)
constexpr int kMaxLanes = 1024;

template <class M>
__global__ void __launch_bounds__(kMaxLanes)
    sweep_kernel(const int* __restrict__ seeds, const float* __restrict__ y,
                 const float* __restrict__ theta,
                 const float* __restrict__ alive_v,
                 const float* __restrict__ thr_v, float* __restrict__ ll_out,
                 float* __restrict__ est_out, const int* __restrict__ gaps,
                 const int* __restrict__ times, int T, int mode,
                 int systematic, int algorithm, M model) {
  extern __shared__ float smem[];
  __shared__ float u_lane0;
  const int n = blockDim.x;
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  const SweepShared shm(smem, n);
  float* red = shm.red;

  const float alive = alive_v[c];
  const float thr = thr_v[c];
  const float lane_f = (float)lane;
  const bool live = lane_f < alive;
  const float w_res = live ? 1.0f / alive : 0.0f;

  Rng rng;
  rng.key = lane_key((uint32_t)seeds[2 * c], (uint32_t)seeds[2 * c + 1],
                     (uint32_t)lane);
  rng.ctr = 0;
  float th[M::P];
#pragma unroll
  for (int j = 0; j < M::P; ++j) th[j] = theta[c * M::P + j];

  float st[M::D];
  model.init(rng, st, th);
  float* est = est_out + (size_t)c * (T + 1) * M::D;
#pragma unroll
  for (int j = 0; j < M::D; ++j) {
    const float e = block_sum(w_res * st[j], red);
    if (lane == 0) est[j] = e;
  }

  float ll = 0.0f;
  bool dead = false;
  for (int t = 0; t < T; ++t) {
    const float* y_t = y + t * M::DY;
    if (gaps != nullptr) {
      const int gap = gaps[t];
      for (int s = 0; s < gap; ++s) {
        model.transition(rng, st, th, times[t] - gap + s);
      }
    } else {
      model.transition(rng, st, th, t);
    }
    float lw;
    if constexpr (M::kHasAux) {
      if (algorithm == kApf) {
        const float alw = live ? model.aux_log_weight(st, th, y_t) : kNeg;
        const float mxa = block_max(alw, red);
        dead = dead || (mxa < kDegenerate);
        const float sha = expf(alw - mxa);
        const float wa = sha / block_sum(sha, red);
        const float pos_a = draw_position(rng, lane_f, alive, live,
                                          systematic, &u_lane0);
        select_model<M>(model, wa, pos_a, st, shm, lane, n, lane_f, alive,
                        live);
        const float aux_anc =
            nan_max(live ? model.aux_log_weight(st, th, y_t) : kNeg, kNeg);
        model.transition(rng, st, th, gaps != nullptr ? times[t] - 1 : t);
        lw = live ? model.log_weight(st, th, y_t) - aux_anc : kNeg;
      } else {
        lw = live ? model.log_weight(st, th, y_t) : kNeg;
      }
    } else {
      lw = live ? model.log_weight(st, th, y_t) : kNeg;
    }
    const float mx = block_max(lw, red);
    dead = dead || (mx < kDegenerate);
    const float sh = expf(lw - mx);
    const float ssum = block_sum(sh, red);
    const float w = sh / ssum;
    const float ess = 1.0f / block_sum(w * w, red);
    ll = ll + mx + logf(ssum) - logf(alive);

    float est_w = w;
    if (mode != kNever) {
      // Every SISR/SISAR day draws its position block, resampled or not.
      const float pos = draw_position(rng, lane_f, alive, live, systematic,
                                      &u_lane0);
      if (mode == kAlways || ess < thr) {  // uniform across the block
        select_model<M>(model, w, pos, st, shm, lane, n, lane_f, alive,
                        live);
        est_w = w_res;
      }
    }
    if constexpr (M::kHasMove) {
      if (algorithm == kRmpf) {
        // Every lane advances the counter; masked lanes keep their state.
        float moved[M::D];
#pragma unroll
        for (int j = 0; j < M::D; ++j) moved[j] = st[j];
        model.move(rng, moved, th, y_t);
        if (live) {
#pragma unroll
          for (int j = 0; j < M::D; ++j) st[j] = moved[j];
        }
      }
    }
    const float live_f = dead ? 0.0f : 1.0f;
#pragma unroll
    for (int j = 0; j < M::D; ++j) {
      const float e = block_sum(est_w * st[j], red) * live_f;
      if (lane == 0) est[(t + 1) * M::D + j] = e;
    }
  }
  if (lane == 0) ll_out[c] = dead ? -INFINITY : ll;
}

template <class M>
int launch_sweep(M model, const int* seeds, const float* y,
                 const float* theta, const float* alive, const float* thr,
                 float* ll, float* est, const int* gaps, const int* times,
                 int C, int N, int T, int mode, int systematic, int algorithm,
                 cudaStream_t stream) {
  if (C < 1 || N < 128 || N > kMaxLanes || (N & (N - 1)) || T < 0 ||
      mode < kAdaptive || mode > kNever ||
      (gaps == nullptr) != (times == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // A day the functor cannot run: APF without an aux weight, RMPF without
  // a move.
  if (algorithm < kBpf || algorithm > kRmpf ||
      (algorithm == kApf && !M::kHasAux) ||
      (algorithm == kRmpf && !M::kHasMove)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = SweepShared::bytes(N, Route<M>::kCols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_kernel<M><<<C, N, smem, stream>>>(seeds, y, theta, alive, thr, ll,
                                          est, gaps, times, T, mode,
                                          systematic, algorithm, model);
  return (int)cudaGetLastError();
}

}  // namespace bssm
