// Fused per-day weight step of the generic filter engine for Hopper
// (sm_90a): max shift, normalised weights, ESS, log-sum-exp, the running-max
// CDF, positions (passed in, or drawn in the kernel), selection and the
// adaptive choice, in one launch.
//
// Replaces bayesssm_tpu/ops/resampling_pallas.py::_kernel (the Pallas TPU
// kernel behind fused_weight_resample and fused_weight_resample_seeded).
// The plain PyTorch version is fused_weight_resample_reference in
// bayesssm_tpu_torch/ops/resampling_fused.py.
//
// Layout: one thread block per chain (grid = C), one thread per particle
// lane; blockDim is the lane count rounded up to a power of two (at least
// 32), and the threads beyond it contribute the reductions' identities.
// Shared memory holds the reduction and scan scratch of reduce.cuh and the
// CDF (about 5.1 x blockDim floats, 21 KB at 1024 lanes). Selection is the
// upper-bound binary search of select.cuh (m_k = #{j : cdf_ext_j <=
// pos_k}) for every position method: on a monotone CDF it picks the same
// ancestor as the TPU kernel's merge network and its quadratic bucket
// test, and it takes unsorted (multinomial) positions as they are. The
// [B, N, N] selection matrix and the one-operand-per-column split were
// Mosaic workarounds and are gone.
//
// What bounds it on this card: the per-day barriers. A day is three
// reductions and the last-alive max (2 barriers each, the in-warp levels
// on shuffles) plus the CDF scan (3) and the selection's one, 12 barriers
// for some 20 flops per lane; the [C, N] reads and writes (about 4 MB at
// 4096 x 128, d = 2) take a couple of microseconds at HBM rate. One block
// per chain keeps every barrier inside a chain, so blocks never wait for
// each other and the card holds 16 such blocks per SM.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "reduce.cuh"
#include "rng.cuh"
#include "select.cuh"

namespace bssm {

constexpr float kCdfSentinel = 1.5f;
// Position modes: host positions, or drawn in the kernel.
enum PositionMode {
  kHostPositions = -1,
  kStratified = 0,
  kSystematic = 1,
  kMultinomial = 2
};

__global__ void fused_resample_kernel(
    const float* __restrict__ lw, const float* __restrict__ parts,
    const float* __restrict__ pos_in, const float* __restrict__ uni,
    const float* __restrict__ thr, const int* __restrict__ seeds,
    const float* __restrict__ alive_v, float* __restrict__ pout,
    float* __restrict__ wout, float* __restrict__ ess_out,
    float* __restrict__ lse_out, int N, int D, int method, int always) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int l = threadIdx.x;
  const int c = blockIdx.x;
  float* red = smem;
  float* cdf = red + reduce_floats(P);
  float* scan = cdf + P;
  const bool real = l < N;
  const size_t row = (size_t)c * N;

  const float lwv = real ? lw[row + l] : -INFINITY;
  const float mx = block_max(lwv, red);
  const float sh = real ? expf(lwv - mx) : 0.0f;
  const float s = block_sum(sh, red);
  const float w = sh / s;
  const float ess = 1.0f / block_sum(w * w, red);
  const float uw = real ? uni[row + l] : 0.0f;
  // Last alive lane: the highest lane with a positive post-resample weight.
  const float last_alive = block_max(uw > 0.0f ? (float)l : 0.0f, red);
  const float c_l = block_cdf(w, scan);
  cdf[l] = real && (float)l >= last_alive ? kCdfSentinel : c_l;
  __syncthreads();

  if (real) {
    const bool resample = always || ess < thr[c];  // uniform per block
    int src = l;
    if (resample) {
      float pos;
      if (method == kHostPositions) {
        pos = pos_in[row + l];
      } else {
        const uint32_t s0 = (uint32_t)seeds[2 * c];
        const uint32_t s1 = (uint32_t)seeds[2 * c + 1];
        const float alive = alive_v[c];
        const float lane_f = (float)l;
        // Systematic: every slot shares lane 0's draw.
        const float u = position_uniform(
            s0, s1, method == kSystematic ? 0u : (uint32_t)l);
        pos = method == kMultinomial ? u : (lane_f + u) / alive;
        if (!(lane_f < alive)) pos = 1.0f;
      }
      src = select_index(cdf, N, pos);
    }
    for (int j = 0; j < D; ++j) {
      pout[(row + l) * D + j] = parts[(row + src) * D + j];
    }
    wout[row + l] = resample ? uw : w;
  }
  if (l == 0) {
    ess_out[c] = ess;
    lse_out[c] = mx + logf(s);
  }
}

}  // namespace bssm

extern "C" {

// C chains of N <= 1024 lanes and D state columns laid out [C, N, D].
// method: -1 takes `pos` [C, N]; 0/1/2 draw stratified/systematic/
// multinomial positions from `seeds` [C, 2] and `alive` [C].
int bssm_fused_resample(const float* lw, const float* parts, const float* pos,
                        const float* uni, const float* thr, const int* seeds,
                        const float* alive, float* pout, float* wout,
                        float* ess, float* lse, int C, int N, int D,
                        int method, int always, void* stream) {
  if (C < 1 || N < 1 || N > 1024 || D < 1 || method < -1 || method > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (method == -1 ? pos == nullptr : (seeds == nullptr || alive == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = 32;
  while (threads < N) threads <<= 1;
  const size_t smem = sizeof(float) * (size_t)(bssm::reduce_floats(threads) +
                                               threads +
                                               bssm::scan_floats(threads));
  bssm::fused_resample_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      lw, parts, pos, uni, thr, seeds, alive, pout, wout, ess, lse, N, D,
      method, always);
  return (int)cudaGetLastError();
}

}  // extern "C"
