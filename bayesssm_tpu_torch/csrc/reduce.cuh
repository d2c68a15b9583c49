// Block reductions shared by the sweep kernel (sweep.cu) and the fused
// weight step (resample.cu).
//
// A fixed halving tree over blockDim.x lanes (a power of two): the plain
// PyTorch versions reproduce its order with tree_sum
// (bayesssm_tpu_torch/ops/sweep_builder.py), so a kernel and its plain
// version agree bit for bit. Threads beyond the data contribute the
// identity (0 for a sum, -inf for a max). Every thread of the block must
// call them.
#pragma once

#include "select.cuh"

namespace bssm {

// Halving-tree block sum: red[l] += red[l + s] for s = n/2 .. 1.
__device__ inline float block_sum(float v, float* red) {
  const int n = blockDim.x, l = threadIdx.x;
  red[l] = v;
  __syncthreads();
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (l < s) red[l] = red[l] + red[l + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ inline float block_max(float v, float* red) {
  const int n = blockDim.x, l = threadIdx.x;
  red[l] = v;
  __syncthreads();
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (l < s) red[l] = nan_max(red[l], red[l + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

}  // namespace bssm
