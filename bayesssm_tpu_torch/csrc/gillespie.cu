// Exact Gillespie SIR day-step of the generic filter engine for Hopper
// (sm_90a): every particle lane of every chain runs the SIR jump process
// over [0, t_end] in one launch.
//
// Replaces bayesssm_tpu/ops/gillespie_pallas.py::_kernel (the Pallas TPU
// kernel behind gillespie_step_pallas, the transition of
// sir_model(transition="gillespie_pallas")). The plain PyTorch version is
// gillespie_step_reference in bayesssm_tpu_torch/ops/gillespie.py.
//
// Layout: one thread block per chain (grid = C), one thread per lane
// (blockDim = N <= 1024); (S, I, t, active) live in registers, and the
// event loop is sir_day from models.cuh, the one the whole-sweep kernel
// runs. Draws are the chain's lowbias32 lane stream (rng.cuh) with the
// counter restarted at 0 on every call: iteration k draws counters
// 2 * unroll * k .. 2 * unroll * (k + 1) - 1, as the TPU kernel's software
// stream does for one chain per program.
//
// What bounds it on this card: the event tail of each chain. A block
// iterates until its LAST lane leaves [0, t_end] (or MAX_EVENTS), and
// every iteration costs each lane two hashes, one log1pf and one division
// per event whether the lane is still live or not. The TPU kernel paid that
// tail once per block of 256 chains; here each chain pays only its own.
// Memory traffic is 16 bytes per lane, read and written once.
#include <cuda_runtime.h>

#include <cstdint>

#include "models.cuh"
#include "rng.cuh"

namespace bssm {

__global__ void gillespie_kernel(const int* __restrict__ seeds,
                                 const float* __restrict__ state,
                                 const float* __restrict__ lam,
                                 const float* __restrict__ gam,
                                 float* __restrict__ out, int N, float inv_nt,
                                 float t_end, int unroll) {
  const int l = threadIdx.x;
  const int c = blockIdx.x;
  Rng rng;
  rng.key = lane_key((uint32_t)seeds[2 * c], (uint32_t)seeds[2 * c + 1],
                     (uint32_t)l);
  rng.ctr = 0;
  const size_t at = ((size_t)c * N + l) * 2;
  float s = state[at];
  float i = state[at + 1];
  sir_day(rng, s, i, lam[c] * inv_nt, gam[c], t_end, unroll);
  out[at] = s;
  out[at + 1] = i;
}

}  // namespace bssm

extern "C" {

// C chains of N <= 1024 lanes; state and out are [C, N, 2] (S, I).
int bssm_gillespie(const int* seeds, const float* state, const float* lam,
                   const float* gam, float* out, int C, int N, float inv_nt,
                   float t_end, int unroll, void* stream) {
  if (C < 1 || N < 1 || N > 1024 || unroll < 1) {
    return (int)cudaErrorInvalidValue;
  }
  bssm::gillespie_kernel<<<C, N, 0, (cudaStream_t)stream>>>(
      seeds, state, lam, gam, out, N, inv_nt, t_end, unroll);
  return (int)cudaGetLastError();
}

}  // extern "C"
