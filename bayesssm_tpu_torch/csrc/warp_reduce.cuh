// Warp-level reductions, CDF scan and selection of the fused weight step
// (resample.cu, K3) and of the standalone selection entry (bssm_select, K2).
//
// Layout. One warp holds a row of P = 32 V lanes in registers: thread t
// holds lanes l = t + 32 k in x[k], k < V (V a power of two up to 32).
// This is reduce.cuh's transposed layout with the whole block in one warp,
// so the plain versions' orders (tree_sum and running_cdf in
// bayesssm_tpu_torch/ops/sweep_builder.py) need no shared memory and no
// barrier:
// * halving tree, level s combines x[l + s] into x[l], lower index first:
//   the levels s >= 32 are register adds x_k += x_{k + s/32}; the levels
//   s <= 16 run on __shfl_down_sync in register 0;
// * doubling scan, x[l] += x[l - s] for s = 1, 2, 4, ... (lanes below s
//   add 0): the levels s <= 16 take one rotation shuffle per register (a
//   thread with t < s takes register k - 1 of thread t - s + 32, or 0 in
//   register 0); the levels s >= 32 are x_k += x_{k - s/32}, k descending;
// * running max (NaN wins): exact in any order, so each register takes a
//   warp prefix max and the maxima of the registers before it.
// tests/test_torch_block_orders.py models each step and holds it bitwise
// against the plain orders.
#pragma once

#include <cstdint>

#include "reduce.cuh"

namespace bssm {

// Bit length of n >= 1: the most halvings an upper-bound search of n
// entries takes.
__device__ __forceinline__ int search_steps(int n) { return 32 - __clz(n); }

// The halving tree over the warp's P = 32 V lanes; every thread gets the
// total. `x` is taken by value.
template <int V, class Op>
__device__ __forceinline__ float warp_tree(const float (&in)[V], Op op) {
  float x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = in[k];
#pragma unroll
  for (int h = V / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) x[k] = op(x[k], x[k + h]);
  }
  float v = x[0];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    v = op(v, __shfl_down_sync(kAllLanes, v, s));
  }
  return __shfl_sync(kAllLanes, v, 0);
}

// The doubling add pass in place over the warp's P lanes: the levels
// s <= 16, then the levels s = 32 h for h < H (H = V: all of them).
template <int V, int H = V>
__device__ __forceinline__ void warp_scan_add(float (&x)[V]) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int from = (t - s) & 31;
#pragma unroll
    for (int k = V - 1; k >= 0; --k) {
      // The thread that reads this one wants register k, or register
      // k - 1 across the row's edge (0 below lane 0).
      const float prev = k > 0 ? x[k > 0 ? k - 1 : 0] : 0.0f;
      const float got = __shfl_sync(kAllLanes, t + s < 32 ? x[k] : prev,
                                    from);
      x[k] = x[k] + (t >= s || k > 0 ? got : 0.0f);
    }
  }
#pragma unroll
  for (int h = 1; h < H; h <<= 1) {
#pragma unroll
    for (int k = V - 1; k >= 0; --k) {
      x[k] = x[k] + (k >= h ? x[k >= h ? k - h : 0] : 0.0f);
    }
  }
}

// The running max in place (NaN wins), given `before`, the max of every
// lane below the warp's (0 at the start of a row): each register's warp
// prefix max, and the maxima of the registers before it.
template <int V>
__device__ __forceinline__ void warp_running_max(float (&x)[V],
                                                 float before) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float run = x[k];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(kAllLanes, run, s);
      if (t >= s) run = nan_max(run, up);
    }
    x[k] = nan_max(run, before);
    before = nan_max(before, __shfl_sync(kAllLanes, run, 31));
  }
}

// The CDF in place, as running_cdf computes it: the add pass, then the
// running max from 0.
template <int V>
__device__ __forceinline__ void warp_cdf(float (&x)[V]) {
  warp_scan_add(x);
  warp_running_max(x, 0.0f);
}

// Upper-bound searches of G positions over cdf[0, n), interleaved: slot g
// gets #{j : cdf_j <= pos_g} clamped to n - 1, by select.cuh's halving
// sequence. A NaN entry or position compares as torch.searchsorted's does
// (`!(cdf[mid] > pos)` moves right), so the slots equal the plain
// version's on any input. `live[g]` false skips a slot (m = 0).
template <int G>
__device__ __forceinline__ void search_slots(const float* cdf, int n,
                                             const float (&pos)[G],
                                             const bool (&live)[G],
                                             int (&m)[G]) {
  int lo[G], hi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lo[g] = 0;
    hi[g] = live[g] ? n : 0;
  }
  const int steps = search_steps(n);
  for (int it = 0; it < steps; ++it) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lo[g] < hi[g]) {
        const int mid = lo[g] + ((hi[g] - lo[g]) >> 1);
        if (cdf[mid] > pos[g]) {
          hi[g] = mid;
        } else {
          lo[g] = mid + 1;
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = lo[g] < n ? lo[g] : n - 1;
}

// Asynchronous 4-byte copy from device memory to shared memory (no
// register is held while it flies); cp_async_wait_all() waits for this
// thread's copies, and a __syncwarp() after it shows them to the warp.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t to = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

}  // namespace bssm
