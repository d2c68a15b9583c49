// Block reductions and the CDF scan shared by the sweep kernel (sweep.cuh)
// and the fused weight step (resample.cu).
//
// Orders. A reduction is the fixed halving tree over blockDim.x lanes (a
// power of two, at least 32): level s combines x[l + s] into x[l] for
// s = n/2 .. 1, the lower index first. The scan is JAX's doubling order,
// x[l] += x[l - s] for s = 1, 2, 4, ... (lanes below s add 0). The plain
// versions reproduce both (tree_sum and running_cdf in
// bayesssm_tpu_torch/ops/sweep_builder.py), so a kernel and its plain
// version agree bit for bit.
//
// Hopper form. The levels with s <= 16 stay inside a warp and run on
// shuffles. Only the levels with s >= 32 cross warps, and they go through
// one shared-memory exchange in a transposed layout: the values of column
// j (lanes j, j + 32, j + 64, ...) sit in nw = n/32 neighbouring lanes of
// one warp, which run those levels with shuffles of width nw. The layout
// pads one float per 32 (padded()), so the transposed reads hit distinct
// banks. A reduction passes 2 barriers and the scan 3, whatever n is.
// Every thread of the block must call them; threads beyond the data
// contribute the identity (0 for a sum, -inf for a max).
#pragma once

#include "select.cuh"

namespace bssm {

constexpr unsigned kAllLanes = 0xffffffffu;

// Floats of a padded [n] array: one pad slot after every 32.
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5); }
// Scratch of a block reduction: the padded values and the 32 column totals.
__host__ __device__ constexpr int reduce_floats(int n) {
  return padded(n) + 32;
}
// Scratch of the CDF scan: the inputs, and two padded arrays.
__host__ __device__ constexpr int scan_floats(int n) {
  return n + 2 * padded(n);
}

__device__ __forceinline__ int pad_at(int l) { return l + (l >> 5); }

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return nan_max(a, b);
  }
};

// The lane's place in the transposed layout: warp w, lane t holds column
// j = w * (32 / nw) + t / nw at depth k = t % nw, that is block lane
// j + 32 k.
struct Transposed {
  int j, k, nw;
  __device__ __forceinline__ Transposed() {
    nw = blockDim.x >> 5;
    const int t = threadIdx.x & 31;
    j = (threadIdx.x >> 5) * (32 / nw) + t / nw;
    k = t % nw;
  }
  __device__ __forceinline__ int at() const { return pad_at(j + 32 * k); }
};

// The halving tree over blockDim.x lanes: each lane stores its value; the
// columns' cross-warp levels run transposed (s = nw/2 .. 1 within each
// column's nw lanes) and leave the 32 column totals in red[padded(n) ..];
// then every warp runs the levels s = 16 .. 1 over them and takes lane
// 0's total. The column totals are read only after the second barrier and
// written only after the first, so consecutive calls may share `red`.
template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
  const int n = blockDim.x, l = threadIdx.x;
  float* col = red + padded(n);
  red[pad_at(l)] = v;
  __syncthreads();
  const Transposed tr;
  float x = red[tr.at()];
  for (int s = tr.nw >> 1; s > 0; s >>= 1) {
    x = op(x, __shfl_down_sync(kAllLanes, x, s, tr.nw));
  }
  if (tr.k == 0) col[tr.j] = x;
  __syncthreads();
  x = col[l & 31];
  for (int s = 16; s > 0; s >>= 1) {
    x = op(x, __shfl_down_sync(kAllLanes, x, s));
  }
  return __shfl_sync(kAllLanes, x, 0);
}

// Block sum over reduce_floats(blockDim.x) floats of scratch.
__device__ __forceinline__ float block_sum(float v, float* red) {
  return block_reduce(v, red, SumOp{});
}

// Block max (NaN wins) over the same scratch.
__device__ __forceinline__ float block_max(float v, float* red) {
  return block_reduce(v, red, MaxOp{});
}

// Block max of a non-negative int: __reduce_max_sync in each warp, then
// one shared-memory step across warps. Two barriers, so calls may follow
// each other with no barrier between.
__device__ __forceinline__ int block_max_int(int v) {
  __shared__ int warp_max[32];
  const int nw = blockDim.x >> 5, t = threadIdx.x & 31;
  v = __reduce_max_sync(kAllLanes, v);
  if (t == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = __reduce_max_sync(kAllLanes, t < nw ? warp_max[t] : 0);
  __syncthreads();
  return v;
}

// The CDF entry of this lane: JAX's doubling scan of w over the block
// (sweep_builder.py:244-254), then a running max (NaN wins), over
// scan_floats(n) floats of scratch. Returns the value; the caller stores
// it.
//
// Add pass, bit for bit the doubling order. Levels s <= 16: after level s
// lane l's window reaches back 2s - 1 lanes, so each warp holds its own
// values `v` and the previous warp's `p` (read once from shared memory)
// and runs the levels on one rotation shuffle each: lane t takes
// v[t - s], or p[t - s + 32] across the warp's edge (0 in warp 0), and p
// takes its own level only where a later level reads it. Levels s >= 32
// run transposed, x_k += x_{k - s/32} down each column.
//
// Max pass: max is exact, so its order changes no value except which NaN
// payload or which zero's sign wins, and a NaN entry selects as "not <=
// pos" whatever its payload: the pass keeps every selected index (held
// with NaN, inf and signed-zero cases by the tests). Its form: each column
// takes an exclusive running max down its depth in the transposed pass;
// after the write-back a lane's entry is the max of its warp's inclusive
// running max (shuffles) and the max over its warp's 32 columns of those
// exclusive maxima, with 0 as the identity, as the plain version starts.
__device__ __forceinline__ float block_cdf(float w, float* scan) {
  const int n = blockDim.x, l = threadIdx.x;
  const int warp = l >> 5, t = l & 31, nw = n >> 5;
  float* in = scan;
  float* sums = scan + n;
  float* col_max = scan + n + padded(n);
  float v = w;
  float p = 0.0f;
  if (nw > 1) {
    in[l] = w;
    __syncthreads();
    if (warp > 0) p = in[l - 32];
  }
  for (int s = 1; s < 32 && s < n; s <<= 1) {
    const float send = t + s < 32 ? v : p;
    const float got = __shfl_sync(kAllLanes, send, (t - s) & 31);
    p = p + __shfl_up_sync(kAllLanes, p, s);
    v = v + (t >= s || warp > 0 ? got : 0.0f);
  }
  float before = 0.0f;  // running max of the warps above this one
  if (nw > 1) {
    sums[pad_at(l)] = v;
    __syncthreads();
    const Transposed tr;
    float x = sums[tr.at()];
    for (int s = 1; s < tr.nw; s <<= 1) {
      const float up = __shfl_up_sync(kAllLanes, x, s, tr.nw);
      x = x + (tr.k >= s ? up : 0.0f);
    }
    float run = x;  // inclusive running max down the column
    for (int s = 1; s < tr.nw; s <<= 1) {
      const float up = __shfl_up_sync(kAllLanes, run, s, tr.nw);
      if (tr.k >= s) run = nan_max(run, up);
    }
    const float up = __shfl_up_sync(kAllLanes, run, 1, tr.nw);
    sums[tr.at()] = x;
    col_max[tr.at()] = tr.k >= 1 ? up : 0.0f;
    __syncthreads();
    v = sums[pad_at(l)];
    before = col_max[pad_at(l)];
    for (int s = 16; s > 0; s >>= 1) {
      before = nan_max(before, __shfl_xor_sync(kAllLanes, before, s));
    }
  }
  float run = nan_max(v, 0.0f);
  for (int s = 1; s < 32; s <<= 1) {
    const float up = __shfl_up_sync(kAllLanes, run, s);
    if (t >= s) run = nan_max(run, up);
  }
  return nan_max(run, before);
}

}  // namespace bssm
