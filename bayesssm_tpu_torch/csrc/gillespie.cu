// Exact Gillespie SIR day-step of the generic filter engine for Hopper
// (sm_90a): every particle lane of every chain runs the SIR jump process
// over [0, t_end] in one launch.
//
// Replaces bayesssm_tpu/ops/gillespie_pallas.py::_kernel (the Pallas TPU
// kernel behind gillespie_step_pallas, the transition of
// sir_model(transition="gillespie_pallas")). The plain PyTorch version is
// gillespie_step_reference in bayesssm_tpu_torch/ops/gillespie.py.
//
// Draws are the chain's lowbias32 lane stream (rng.cuh) with the counter
// restarted at 0 on every call, and the kernel writes only the state. So a
// lane's day depends on its own key, state and rates alone (models.cuh::
// sir_lane): attempt a draws counters 2a and 2a + 1 whatever the other
// lanes do, and the TPU kernel's chain-wide loop and its counter after the
// day do not constrain this kernel.
//
// Layout: a flat grid over the C x N lanes, kThreads a block, one thread a
// lane, with no barrier: a warp runs 32 neighbouring lanes of a chain and
// leaves as soon as its own slowest lane is done, and the card's block
// scheduler hands the next block to the SM it frees.
//
// What bounds it on this card: instruction issue for the events (two
// hashes, one log1pf and one division each, about 72 lane instructions);
// memory is 16 bytes a lane, read and written once. The design keeps the
// event tail to a warp's: a warp issues each attempt of its slowest lane
// for all 32 lanes, but no lane waits for another warp's lanes and no
// thread passes a barrier. (A persistent grid that hands finished threads
// new lanes from a counter trims that tail on widely spread states but
// lost on the engine's own: scripts/torch_event_loop_forms.py.)
#include <cuda_runtime.h>

#include <cstdint>

#include "models.cuh"
#include "rng.cuh"

namespace bssm {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    gillespie_kernel(const int* __restrict__ seeds,
                     const float* __restrict__ state,
                     const float* __restrict__ lam,
                     const float* __restrict__ gam, float* __restrict__ out,
                     int total, int N, float inv_nt, float t_end, int cap) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const int c = g / N;
  const int l = g - c * N;
  Rng rng;
  rng.key = lane_key((uint32_t)seeds[2 * c], (uint32_t)seeds[2 * c + 1],
                     (uint32_t)l);
  rng.ctr = 0;
  const size_t at = 2 * (size_t)g;
  float s = state[at];
  float i = state[at + 1];
  sir_lane(rng, 0, s, i, lam[c] * inv_nt, gam[c], t_end, cap);
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
  const int total = C * N;
  const int blocks = (total + bssm::kThreads - 1) / bssm::kThreads;
  bssm::gillespie_kernel<<<blocks, bssm::kThreads, 0,
                           (cudaStream_t)stream>>>(
      seeds, state, lam, gam, out, total, N, inv_nt, t_end,
      bssm::event_cap(unroll));
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of the kernel.
int bssm_gillespie_info(int* regs, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bssm::gillespie_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bssm::gillespie_kernel, bssm::kThreads, 0);
}

}  // extern "C"
