// Inverse-CDF selection device functions of the whole-sweep kernel.
//
// Replaces the bitonic lane-roll merge network of
// bayesssm_tpu/ops/merge_select.py (merge_select_cols + resolve_carries),
// which stood in for a gather under Mosaic: slot k takes the value at
// m_k = #{j : cdf_ext[j] <= pos_k}, found by an upper-bound binary search
// over the CDF in shared memory. Both only copy values, so the result is
// the JAX function's, bit for bit.
#pragma once

namespace bssm {

// torch.maximum / jnp.maximum semantics: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// m_k for one position over n sorted values, clamped to n - 1.
__device__ __forceinline__ int select_index(const float* cdf, int n,
                                            float pos) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n ? lo : n - 1;
}

// Inclusive Hillis-Steele scan of w over the block, then a running max, in
// the doubling order of the JAX kernel (sweep_builder.py:244-254), so the
// bits match the plain version for the same w. 2 * log2(n) barrier pairs.
// Every thread of the block must call it.
__device__ __forceinline__ void block_cdf(float w, float* cdf, int lane,
                                          int n) {
  cdf[lane] = w;
  __syncthreads();
  for (int s = 1; s < n; s <<= 1) {
    const float a = lane >= s ? cdf[lane - s] : 0.0f;
    __syncthreads();
    cdf[lane] = cdf[lane] + a;
    __syncthreads();
  }
  for (int s = 1; s < n; s <<= 1) {
    const float a = lane >= s ? cdf[lane - s] : 0.0f;
    __syncthreads();
    cdf[lane] = nan_max(cdf[lane], a);
    __syncthreads();
  }
}

}  // namespace bssm
