// Whole-sweep bootstrap particle filter for Hopper (sm_90a).
//
// Replaces bayesssm_tpu/ops/sweep_builder.py::_make_kernel (the Pallas TPU
// kernel of the SIR PMMH main path) together with the selection it traces
// from bayesssm_tpu/ops/merge_select.py. The plain PyTorch version is
// SweepOp.sweep_reference in bayesssm_tpu_torch/ops/sweep_builder.py.
//
// Layout: one thread block per chain (grid = C), one thread per particle
// lane (blockDim = max_particles, a power of two in 128..1024). A thread
// keeps its particle's state in registers for all T days; y is read-only
// in global memory; shared memory holds the reduction scratch, the CDF and
// the ancestor-copy buffer ((2 + D) * N floats, 16 KB at N = 1024, D = 2).
// Lanes >= alive stay inert but reach every barrier.
//
// What bounds it on this card: the SIR event loop (per event two hashes,
// one log1pf and one divide per lane, plus the chain's tail of events:
// the block iterates until its LAST lane is done) and the barriers of the
// block reductions and the CDF scan (about 2 log2 N per day for the scan
// and log2 N per reduction). One chain per block pays the event tail per
// chain, where the TPU kernel paid it once per block of 256 chains; on the
// other hand no chain waits for a slower neighbour. Reductions use a fixed
// halving tree so the plain version (tree_sum) reproduces their bits.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "models.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "select.cuh"

namespace bssm {

constexpr float kNeg = -1e30f;
constexpr float kDegenerate = -1e8f;
constexpr float kSentinel = 1.5f;
enum Mode { kAdaptive = 0, kAlways = 1, kNever = 2 };

template <class M>
__global__ void sweep_kernel(const int* __restrict__ seeds,
                             const float* __restrict__ y,
                             const float* __restrict__ theta,
                             const float* __restrict__ alive_v,
                             const float* __restrict__ thr_v,
                             float* __restrict__ ll_out,
                             float* __restrict__ est_out, int T, int mode,
                             int systematic, M model) {
  extern __shared__ float smem[];
  __shared__ float u_lane0;
  const int n = blockDim.x;
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  float* red = smem;
  float* cdf = smem + n;
  float* buf = smem + 2 * n;

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
    model.transition(rng, st, th, t);
    const float lw = live ? model.log_weight(st, th, y + t * M::DY) : kNeg;
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
      float u = rng.uniform();
      if (systematic) {
        if (lane == 0) u_lane0 = u;
        __syncthreads();
        u = u_lane0;
        __syncthreads();
      }
      const float pos = live ? (lane_f + u) / alive : 1.0f;
      if (mode == kAlways || ess < thr) {  // uniform across the block
        block_cdf(w, cdf, lane, n);
        if (lane_f >= alive - 1.0f) cdf[lane] = kSentinel;
#pragma unroll
        for (int j = 0; j < M::D; ++j) buf[j * n + lane] = st[j];
        __syncthreads();
        const int m = select_index(cdf, n, pos);
#pragma unroll
        for (int j = 0; j < M::D; ++j) st[j] = live ? buf[j * n + m] : 0.0f;
        __syncthreads();
        est_w = w_res;
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

__global__ void select_kernel(const float* __restrict__ cdf,
                              const float* __restrict__ pos,
                              const float* __restrict__ vals,
                              float* __restrict__ out, int R, int N, int D) {
  extern __shared__ float s_cdf[];
  const int r = blockIdx.x, l = threadIdx.x;
  s_cdf[l] = cdf[(size_t)r * N + l];
  __syncthreads();
  const int m = select_index(s_cdf, N, pos[(size_t)r * N + l]);
  for (int j = 0; j < D; ++j) {
    const size_t row = ((size_t)j * R + r) * N;
    out[row + l] = vals[row + m];
  }
}

template <class M>
int launch_sweep(M model, const int* seeds, const float* y,
                 const float* theta, const float* alive, const float* thr,
                 float* ll, float* est, int C, int N, int T, int mode,
                 int systematic, cudaStream_t stream) {
  if (C < 1 || N < 128 || N > 1024 || (N & (N - 1)) || T < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(2 + M::D) * N * sizeof(float);
  sweep_kernel<M><<<C, N, smem, stream>>>(seeds, y, theta, alive, thr, ll,
                                          est, T, mode, systematic, model);
  return (int)cudaGetLastError();
}

}  // namespace bssm

extern "C" {

int bssm_sweep_sir(const int* seeds, const float* y, const float* theta,
                   const float* alive, const float* thr, float* ll,
                   float* est, int C, int N, int T, int mode,
                   int systematic, float inv_nt, float s0, float i0,
                   int unroll, void* stream) {
  if (unroll < 1) return (int)cudaErrorInvalidValue;
  bssm::SirModel model{inv_nt, s0, i0, unroll};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est, C,
                            N, T, mode, systematic, (cudaStream_t)stream);
}

int bssm_sweep_lgss(const int* seeds, const float* y, const float* theta,
                    const float* alive, const float* thr, float* ll,
                    float* est, int C, int N, int T, int mode,
                    int systematic, float c, float p0, void* stream) {
  bssm::LgssModel model{c, p0};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est, C,
                            N, T, mode, systematic, (cudaStream_t)stream);
}

// The selection device function alone, over R rows of N <= 1024 lanes and
// D value columns laid out [D, R, N].
int bssm_select(const float* cdf, const float* pos, const float* vals,
                float* out, int R, int N, int D, void* stream) {
  if (R < 1 || N < 1 || N > 1024 || D < 1) return (int)cudaErrorInvalidValue;
  bssm::select_kernel<<<R, N, N * sizeof(float), (cudaStream_t)stream>>>(
      cdf, pos, vals, out, R, N, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
