// Counter-based lowbias32 stream of the whole-sweep kernel.
//
// The same words as bayesssm_tpu_torch/ops/rng.py (the plain version) and
// as the JAX sweep's interpret-mode software stream for one chain per
// program (bayesssm_tpu/ops/sweep_builder.py:185-224, program id 0, row
// 0). All arithmetic is uint32_t: multiplies wrap mod 2^32 and shifts are
// logical, as the JAX int32 code gets by masking.
#pragma once

#include <cstdint>

namespace bssm {

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-chain row mix (sweep_builder.py:189-193): lowbias32 without its
// final xor-shift.
__device__ __forceinline__ uint32_t row_mix(uint32_t s0, uint32_t s1) {
  uint32_t r = s0 ^ (s1 * 0x9E3779B9u + 1u);
  r ^= r >> 16;
  r *= 0x7FEB352Du;
  r ^= r >> 15;
  return r * 0x846CA68Bu;
}

__device__ __forceinline__ uint32_t lane_key(uint32_t s0, uint32_t s1,
                                             uint32_t lane) {
  const uint32_t base = hash32(s0 ^ hash32(s1 ^ hash32(0u)));
  return hash32(base + lane * 0x9E3779B9u) ^ row_mix(s0, s1);
}

// Uniform of the fused weight step's in-kernel positions
// (bayesssm_tpu/ops/resampling_pallas.py:156-166, one chain per program):
// the row mix sits inside the hash and there is no draw counter.
__device__ __forceinline__ float position_uniform(uint32_t s0, uint32_t s1,
                                                  uint32_t lane) {
  const uint32_t base = hash32(s0 ^ hash32(s1 ^ hash32(0u)));
  const uint32_t bits = hash32((base + lane * 0x9E3779B9u) ^ row_mix(s0, s1));
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// One lane's view of its chain's stream. `ctr` is the chain's draw
// counter: every thread of a block advances it identically.
struct Rng {
  uint32_t key;
  int ctr;

  __device__ __forceinline__ float uniform_at(int k) const {
    const uint32_t bits = hash32(key ^ ((uint32_t)k * 0x85EBCA6Bu));
    return (float)(bits >> 8) * (1.0f / 16777216.0f);
  }

  __device__ __forceinline__ float uniform() { return uniform_at(ctr++); }

  // Box-Muller from two consecutive blocks (SweepRng.normal).
  __device__ __forceinline__ float normal() {
    const float u0 = uniform_at(ctr);
    const float u1 = uniform_at(ctr + 1);
    ctr += 2;
    const float r = sqrtf(-2.0f * logf(1.0f - u0));
    return r * cosf(6.283185307179586f * u1);
  }
};

}  // namespace bssm
