// Inverse-CDF selection device functions of the whole-sweep kernel (the
// CDF it searches comes from reduce.cuh::block_cdf).
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

}  // namespace bssm
