// Fused per-day weight step of the generic filter engine for Hopper
// (sm_90a): max shift, normalised weights, ESS, log-sum-exp, the running-max
// CDF, positions (passed in, or drawn in the kernel), selection and the
// adaptive choice, in one launch (K3); and the selection alone over [D, R,
// N] columns (bssm_select, K2's standalone entry).
//
// Replaces bayesssm_tpu/ops/resampling_pallas.py::_kernel (the Pallas TPU
// kernel behind fused_weight_resample and fused_weight_resample_seeded) and
// the merge network of bayesssm_tpu/ops/merge_select.py. The plain PyTorch
// versions are fused_weight_resample_reference in
// bayesssm_tpu_torch/ops/resampling_fused.py and select_cols_reference in
// bayesssm_tpu_torch/ops/merge_select.py; both kernels equal them bit for
// bit.
//
// What bounds it: bytes. A chain reads its log-weights, uniform weights and
// its [N, D] particle row and writes them back (chip_smoke.py::
// fused_resample_bound: 14.8 MB at 4096 x 128 x 2, 4.4 us at 3.35 TB/s);
// its arithmetic is some 20 flops a lane.
//
// Design. Up to 256 lanes, one warp a chain, its P = 32 V lanes in
// registers (thread t holds lanes t + 32 k), 8 chains a block (2 at 256
// lanes), and a warp past the last chain exits at once. The reductions and the CDF scan run in
// the registers and on shuffles in the plain versions' orders
// (warp_reduce.cuh), so no shared-memory exchange and no barrier is left:
// the block-per-chain form spent 12 __syncthreads a call, issued by every
// warp of the chain, for those 20 flops, and 4096 chains of four warps made
// 1.94 waves of the card. From 512 lanes on, where one warp would hold 80
// to 128 registers of lanes and few warps fit an SM, a team of P / 128
// warps takes a chain, 4 lanes a thread, and what crosses warps goes
// through one shared-memory exchange behind a block barrier (the team
// form below; the launchers' fixed table picks). Every load is issued at the
// top: the chain's scalars, one 128-byte warp load per register of
// log-weights and uniform weights, and the contiguous particle row into
// shared memory by cp.async, which flies while the weights are reduced. A
// chain that keeps its particles (not always, and ess >= thr or NaN)
// writes its weights and copies its row through, with no CDF, position or
// search, whose values the plain version discards. A resampling chain
// writes its CDF (1.5 from the last alive lane on) to shared memory, runs
// its upper-bound searches interleaved, and writes the gathered row as
// consecutive floats.
//
// The engine's day. Given the day's pointers (FusedArgs::ll_out and the
// rest), the same launch does the whole weight step of the engine's day
// (bayesssm_tpu_torch/filters/core.py): it masks the lanes at or above the
// chain's count to -inf and clamps at -1e30 as it loads the raw
// log-weights, marks the chain dead when their max is below -1e8, adds
// lse - log n to the running log-likelihood (-inf once dead), writes the
// ESS record (the count after a resample, 0 once dead), zeroes a dead
// chain's weights, and sums the state estimate sum_l w_l x[l, :] of the
// output weights and rows in the halving tree. These are per-chain values
// the kernel already holds, so a day adds a few bytes a chain and no pass
// over [C, N]; the plain version restates each step in this order.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "rng.cuh"
#include "warp_reduce.cuh"

namespace bssm {

constexpr float kCdfSentinel = 1.5f;
// Position modes: host positions, or drawn in the kernel.
enum PositionMode {
  kHostPositions = -1,
  kStratified = 0,
  kSystematic = 1,
  kMultinomial = 2
};
// Searches in flight together per thread.
constexpr int kSearchGroup = 8;
// Shared memory a block may take (opt-in above 48 KB).
constexpr int kMaxSharedBytes = 227 * 1024;

// Clamp of the masked log-weights, and the engine's degenerate bound.
constexpr float kFusedFloor = -1e30f;
constexpr float kDegenerate = -1e8f;

struct FusedArgs {
  const float* lw;
  const float* parts;
  const float* pos;
  const float* uni;
  const float* thr;
  const long long* words;  // [C, 2] uint32 key words as int64, rows apart
  long long word_stride;   // by word_stride
  const float* alive;
  float* pout;
  float* wout;
  float* ess;
  float* lse;
  // The engine's day (all null outside it; est may be null in it): the
  // running log-likelihood in and out, the dead flags (in place), log n,
  // the ESS record and the [C, D] state estimate.
  const float* ll_in;
  float* ll_out;
  bool* dead;
  const float* log_n;
  float* ess_rec;
  float* est;
  int C, N, D, method, always;
};

// Lane l's log-weight on the engine's day: -inf at or above the chain's
// count (as the engine's `alive` compares), then clamped at -1e30 with
// clamp_min's rule (NaN stays).
__device__ __forceinline__ float day_log_weight(float v, int l, float alive) {
  if (!((float)l < alive)) v = -INFINITY;
  return v < kFusedFloor ? kFusedFloor : v;
}

// The chain's key words: the low 32 bits of its two int64 words (the
// words hold uint32 values), read as such.
__device__ __forceinline__ void chain_words(const FusedArgs& a, int c,
                                            uint32_t& s0, uint32_t& s1) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      a.words + (size_t)c * (size_t)a.word_stride);
  s0 = w[0];
  s1 = w[2];
}

// The day's per-chain outputs, by one thread: the dead flag, the running
// log-likelihood (ll + (lse - log n), the engine's order) and the ESS
// record. The flag is only ever set, so a lane that reads it after this
// write computes the same `dead` as one that reads it before.
__device__ __forceinline__ void write_day(const FusedArgs& a, int c, float lse,
                                          float ess, bool dead,
                                          bool resampled, float alive) {
  if (dead) a.dead[c] = true;
  a.ll_out[c] = dead ? -INFINITY : a.ll_in[c] + (lse - a.log_n[c]);
  a.ess_rec[c] = dead ? 0.0f : (resampled ? alive : ess);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of one warp's shared segment: the particle row (when it is staged)
// and P floats for the CDF, then the ancestors.
__host__ __device__ constexpr int fused_segment(int p, int nd, bool row) {
  return (row ? round4(nd) : 0) + p;
}

// out[i] = row[src[i / D] * D + i % D] for i = t, t + 32, ... < N D: the
// ancestors' rows, written as consecutive floats. `src` holds the ancestor
// indices' bits.
__device__ __forceinline__ void gather_rows(float* out, const float* row,
                                            const float* src, int nd, int d) {
  const int t = threadIdx.x & 31;
  const int dq = 32 / d, dr = 32 - dq * d;
  int slot = t / d, j = t - slot * d;
  for (int i = t; i < nd; i += 32) {
    out[i] = row[__float_as_int(src[slot]) * d + j];
    slot += dq;
    j += dr;
    if (j >= d) {
      j -= d;
      ++slot;
    }
  }
}

// Lane l's term of column j of the engine's day's state estimate, read
// back once the chain's outputs are written: the output weight this
// thread wrote times row[m D + j], m the ancestor whose bits `anc` holds
// at lane l (l itself for a kept chain, anc null). Nothing is held in
// registers for it through the step, nor from one column's tree to the
// next.
__device__ __forceinline__ float estimate_term(const FusedArgs& a, int c,
                                               int l, int j, const float* row,
                                               const float* anc) {
  if (l >= a.N) return 0.0f;
  const int m = anc != nullptr ? __float_as_int(anc[l]) : l;
  return a.wout[(size_t)c * a.N + l] * row[m * a.D + j];
}

// The state estimate over the warp's lanes: column j sums the lanes'
// terms in the halving tree (lanes past N add 0), one tree a column.
template <int V>
__device__ __forceinline__ void warp_estimate(const FusedArgs& a, int c,
                                              const float* row,
                                              const float* anc) {
  const int t = threadIdx.x & 31;
#pragma unroll 1  // one column's tree at a time
  for (int j = 0; j < a.D; ++j) {
    float p[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p[k] = estimate_term(a, c, t + 32 * k, j, row, anc);
    }
    const float e = warp_tree(p, SumOp{});
    if (t == 0) a.est[(size_t)c * a.D + j] = e;
  }
}

template <int V, bool kRow, bool kDay>
__device__ __forceinline__ void fused_warp(const FusedArgs& a) {
  extern __shared__ float smem[];
  constexpr int P = 32 * V;
  const int t = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + wi;
  if (c >= a.C) return;
  const int N = a.N, D = a.D, nd = N * D;
  float* row_s = smem + (size_t)wi * fused_segment(P, nd, kRow);
  float* cdf_s = row_s + (kRow ? round4(nd) : 0);
  const size_t row = (size_t)c * N;
  const float* prow = a.parts + row * D;
  float* orow = a.pout + row * D;

  if (kRow) {
    for (int i = t; i < nd; i += 32) cp_async4(row_s + i, prow + i);
  }
  const float thr = a.thr[c];
  const bool drawn = a.method != kHostPositions;
  constexpr bool day = kDay;
  uint32_t s0 = 0, s1 = 0;
  float alive = 0.0f;
  if (drawn) chain_words(a, c, s0, s1);
  if (drawn || day) alive = a.alive[c];
  float x[V], u[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = t + 32 * k;
    x[k] = l < N ? a.lw[row + l] : -INFINITY;
    if (day && l < N) x[k] = day_log_weight(x[k], l, alive);
    u[k] = l < N ? a.uni[row + l] : 0.0f;
  }

  const float mx = warp_tree(x, MaxOp{});
  const bool dead = day && (a.dead[c] || mx < kDegenerate);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = t + 32 * k < N ? expf(x[k] - mx) : 0.0f;
  }
  const float s = warp_tree(x, SumOp{});
  float sq[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = x[k] / s;
    sq[k] = x[k] * x[k];
  }
  const float ess = 1.0f / warp_tree(sq, SumOp{});
  const bool keep = !(a.always || ess < thr);  // uniform over the warp
  if (t == 0) {
    const float lse = mx + logf(s);
    a.ess[c] = ess;
    a.lse[c] = lse;
    if (day) write_day(a, c, lse, ess, dead, !keep, alive);
  }

  if (keep) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int l = t + 32 * k;
      if (dead) x[k] = 0.0f;
      if (l < N) a.wout[row + l] = x[k];
    }
    if (kRow) {
      cp_async_wait_all();
      __syncwarp();
      for (int i = t; i < nd; i += 32) orow[i] = row_s[i];
    } else {
      for (int i = t; i < nd; i += 32) orow[i] = prow[i];
    }
    if (day && a.est != nullptr) {
      warp_estimate<V>(a, c, kRow ? row_s : prow, nullptr);
    }
    return;
  }

  // Last alive lane: the highest lane with a positive uniform weight.
  int last = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = t + 32 * k;
    if (l < N && u[k] > 0.0f) last = l;
    if (dead) u[k] = 0.0f;
    if (l < N) a.wout[row + l] = u[k];
  }
  last = __reduce_max_sync(kAllLanes, last);
  warp_cdf(x);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = t + 32 * k;
    if (l < N) cdf_s[l] = l >= last ? kCdfSentinel : x[k];
  }
  __syncwarp();

  // Positions, drawn per lane as the plain version draws them (systematic:
  // lane 0's uniform for every slot), then the searches, G at a time.
  constexpr int G = V < kSearchGroup ? V : kSearchGroup;
  const float u0 = a.method == kSystematic ? position_uniform(s0, s1, 0u)
                                           : 0.0f;
  int src[V];
#pragma unroll
  for (int kb = 0; kb < V; kb += G) {
    float pos[G];
    bool live[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int l = t + 32 * (kb + g);
      live[g] = l < N;
      if (!drawn) {
        pos[g] = live[g] ? a.pos[row + l] : 0.0f;
      } else {
        const float lane_f = (float)l;
        const float uu = a.method == kSystematic
                             ? u0
                             : position_uniform(s0, s1, (uint32_t)l);
        pos[g] = a.method == kMultinomial ? uu : (lane_f + uu) / alive;
        if (!(lane_f < alive)) pos[g] = 1.0f;
      }
    }
    int m[G];
    search_slots(cdf_s, N, pos, live, m);
#pragma unroll
    for (int g = 0; g < G; ++g) src[kb + g] = m[g];
  }
  __syncwarp();  // every search has read the CDF: its floats take the
                 // ancestors
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = t + 32 * k;
    if (l < N) cdf_s[l] = __int_as_float(src[k]);
  }
  if (kRow) cp_async_wait_all();
  __syncwarp();
  gather_rows(orow, kRow ? row_s : prow, cdf_s, nd, D);
  if (day && a.est != nullptr) {
    warp_estimate<V>(a, c, kRow ? row_s : prow, cdf_s);
  }
}

// Blocks of 256 threads an SM the warp form is held to, so that its
// registers are set here and not by ptxas's default caps, which spilled a
// few bytes at some lane counts: up to 128 lanes 6 (40 registers, 48
// warps an SM), or 5 for the engine's day at 128 lanes (48 registers, 40
// warps); from 256 lanes 1, what the kernel needs (72 to 248 registers).
__host__ __device__ constexpr int k3_min_blocks(int v, bool day) {
  return v > 4 ? 1 : (day && v == 4 ? 5 : 6);
}

// K3's warp form: the step alone, and the engine's day, each its own
// kernel, so that the step holds none of the day's code or registers.
template <int V, bool kRow>
__global__ void __launch_bounds__(256, k3_min_blocks(V, false))
    fused_resample_kernel(FusedArgs a) {
  fused_warp<V, kRow, false>(a);
}
template <int V, bool kRow>
__global__ void __launch_bounds__(256, k3_min_blocks(V, true))
    fused_resample_day(FusedArgs a) {
  fused_warp<V, kRow, true>(a);
}
using FusedKernel = void (*)(FusedArgs);
template <int V, bool kRow, bool kDay>
FusedKernel warp_kernel() {
  return kDay ? &fused_resample_day<V, kRow> : &fused_resample_kernel<V, kRow>;
}

constexpr int kTeamV = 4;
// Resident warps an SM the team form's engine day is held to (its
// registers at most 65536 / (32 * 40) = 51, so 48 as allocated), those of
// the step alone: the day adds no register to the step's.
constexpr int kTeamWarpsPerSm = 40;

// The team form (lane bounds of 256 and more; the launchers' table takes
// it from 512 on): one chain a block of W = P / 128 warps, 4 lanes a
// thread, lane l = 128 w + 32 k + t (warp w holds lanes 128 w .. 128 w +
// 127). What crosses warps goes through one shared-memory exchange behind
// one block barrier.
//
// The halving tree over the team: every warp stores its lanes, then each
// thread runs the levels above one warp's span over the W values of its
// positions (lower index first), and the warp's own levels.
template <int W, class Op>
__device__ __forceinline__ float team_tree(const float (&x)[kTeamV], Op op,
                                           float* buf) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTeamV; ++k) buf[128 * w + 32 * k + t] = x[k];
  __syncthreads();
  float y[kTeamV];
#pragma unroll
  for (int k = 0; k < kTeamV; ++k) {
    float z[W];
#pragma unroll
    for (int v = 0; v < W; ++v) z[v] = buf[128 * v + 32 * k + t];
#pragma unroll
    for (int h = W / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int v = 0; v < h; ++v) z[v] = op(z[v], z[v + h]);
    }
    y[k] = z[0];
  }
  return warp_tree(y, op);
}

// The state estimate over the team's lanes (as warp_estimate), one team
// tree a column, the trees' exchange buffers taken in turns so that a
// tree's stores never meet the last one's loads.
template <int W>
__device__ __forceinline__ void team_estimate(const FusedArgs& a, int c,
                                              const float* row,
                                              const float* anc, float* buf0,
                                              float* buf1) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1  // one column's tree at a time
  for (int j = 0; j < a.D; ++j) {
    float p[kTeamV];
#pragma unroll
    for (int k = 0; k < kTeamV; ++k) {
      p[k] = estimate_term(a, c, 128 * w + 32 * k + t, j, row, anc);
    }
    const float e = team_tree<W>(p, SumOp{}, j & 1 ? buf0 : buf1);
    if (threadIdx.x == 0) a.est[(size_t)c * a.D + j] = e;
  }
}

// The doubling scan over the team: the in-warp levels (s <= 64) run over
// the previous warp's raw registers and this warp's (warp_scan_add<8, 4>),
// which is exact for this warp's lanes, whose windows reach back at most
// 127 lanes; the levels s >= 128 are a doubling scan over the W warps at
// each position, after a second exchange, and the max of the warps before
// this one seeds its running max. Seven barriers a resampling chain, three
// a kept one (and one more, then one a column, for the day's estimate).
template <int W, bool kDay>
__device__ __forceinline__ void fused_team(const FusedArgs& a) {
  constexpr int V = kTeamV, P = 128 * W, S = 32 * W;
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, tid = threadIdx.x;
  const int c = blockIdx.x;
  const int N = a.N, D = a.D, nd = N * D;
  float* row_s = smem;
  float* cdf_s = row_s + round4(nd);
  float* buf0 = cdf_s + P;
  float* buf1 = buf0 + P;
  float* src_s = buf1 + P;
  int* last_s = reinterpret_cast<int*>(src_s + P);
  const size_t row = (size_t)c * N;
  const float* prow = a.parts + row * D;
  float* orow = a.pout + row * D;
  for (int i = tid; i < nd; i += S) cp_async4(row_s + i, prow + i);
  const float thr = a.thr[c];
  const bool drawn = a.method != kHostPositions;
  constexpr bool day = kDay;
  uint32_t s0 = 0, s1 = 0;
  float alive = 0.0f;
  if (drawn) chain_words(a, c, s0, s1);
  if (drawn || day) alive = a.alive[c];
  float x[V], u[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = 128 * w + 32 * k + t;
    x[k] = l < N ? a.lw[row + l] : -INFINITY;
    if (day && l < N) x[k] = day_log_weight(x[k], l, alive);
    u[k] = l < N ? a.uni[row + l] : 0.0f;
  }
  const float mx = team_tree<W>(x, MaxOp{}, buf0);
  const bool dead = day && (a.dead[c] || mx < kDegenerate);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = 128 * w + 32 * k + t < N ? expf(x[k] - mx) : 0.0f;
  }
  const float s = team_tree<W>(x, SumOp{}, buf1);
  float sq[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = x[k] / s;
    sq[k] = x[k] * x[k];
  }
  const float ess = 1.0f / team_tree<W>(sq, SumOp{}, buf0);
  const bool keep = !(a.always || ess < thr);  // uniform over the block
  if (tid == 0) {
    const float lse = mx + logf(s);
    a.ess[c] = ess;
    a.lse[c] = lse;
    if (day) write_day(a, c, lse, ess, dead, !keep, alive);
  }
  if (keep) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int l = 128 * w + 32 * k + t;
      if (dead) x[k] = 0.0f;
      if (l < N) a.wout[row + l] = x[k];
    }
    cp_async_wait_all();  // each thread copies what it staged
    for (int i = tid; i < nd; i += S) orow[i] = row_s[i];
    if (day && a.est != nullptr) {
      __syncthreads();  // the estimate reads every thread's staged floats
      team_estimate<W>(a, c, row_s, nullptr, buf0, buf1);
    }
    return;
  }
  int last = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = 128 * w + 32 * k + t;
    if (l < N && u[k] > 0.0f) last = l;
    if (dead) u[k] = 0.0f;
    if (l < N) a.wout[row + l] = u[k];
  }
  last = __reduce_max_sync(kAllLanes, last);
  // Exchange the raw weights and each warp's last alive lane; the in-warp
  // levels run over the previous warp's registers and this warp's.
#pragma unroll
  for (int k = 0; k < V; ++k) buf1[128 * w + 32 * k + t] = x[k];
  if (t == 0) last_s[w] = last;
  __syncthreads();
#pragma unroll
  for (int v = 0; v < W; ++v) last = max(last, last_s[v]);
  float r[2 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    r[k] = w > 0 ? buf1[128 * (w - 1) + 32 * k + t] : 0.0f;
    r[V + k] = x[k];
  }
  warp_scan_add<2 * V, V>(r);
  // The levels s >= 128: a doubling scan over the W warps at each
  // position, and the running max of the warps before this one.
#pragma unroll
  for (int k = 0; k < V; ++k) buf0[128 * w + 32 * k + t] = r[V + k];
  __syncthreads();
  float before = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float z[W];
#pragma unroll
    for (int v = 0; v < W; ++v) z[v] = buf0[128 * v + 32 * k + t];
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
#pragma unroll
      for (int v = W - 1; v >= 0; --v) {
        z[v] = z[v] + (v >= d ? z[v >= d ? v - d : 0] : 0.0f);
      }
    }
#pragma unroll
    for (int v = 0; v < W; ++v) {
      if (v == w) x[k] = z[v];
      if (v < w) before = nan_max(before, z[v]);
    }
  }
#pragma unroll
  for (int q = 16; q > 0; q >>= 1) {
    before = nan_max(before, __shfl_xor_sync(kAllLanes, before, q));
  }
  warp_running_max(x, before);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = 128 * w + 32 * k + t;
    if (l < N) cdf_s[l] = l >= last ? kCdfSentinel : x[k];
  }
  __syncthreads();
  const float u0 = a.method == kSystematic ? position_uniform(s0, s1, 0u)
                                           : 0.0f;
  float pos[V];
  bool live[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = 128 * w + 32 * k + t;
    live[k] = l < N;
    if (!drawn) {
      pos[k] = live[k] ? a.pos[row + l] : 0.0f;
    } else {
      const float lane_f = (float)l;
      const float uu = a.method == kSystematic
                           ? u0
                           : position_uniform(s0, s1, (uint32_t)l);
      pos[k] = a.method == kMultinomial ? uu : (lane_f + uu) / alive;
      if (!(lane_f < alive)) pos[k] = 1.0f;
    }
  }
  int m[V];
  search_slots(cdf_s, N, pos, live, m);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (live[k]) src_s[128 * w + 32 * k + t] = __int_as_float(m[k]);
  }
  cp_async_wait_all();
  __syncthreads();
  const int dq = S / D, dr = S - dq * D;
  int slot = tid / D, j = tid - slot * D;
  for (int i = tid; i < nd; i += S) {
    orow[i] = row_s[__float_as_int(src_s[slot]) * D + j];
    slot += dq;
    j += dr;
    if (j >= D) {
      j -= D;
      ++slot;
    }
  }
  if (day && a.est != nullptr) {
    team_estimate<W>(a, c, row_s, src_s, buf0, buf1);
  }
}

// K3's team form: the step alone, and the engine's day held to the
// step's registers (kTeamWarpsPerSm).
template <int W>
__global__ void __launch_bounds__(32 * W) fused_resample_team(FusedArgs a) {
  fused_team<W, false>(a);
}
template <int W>
__global__ void __launch_bounds__(32 * W, kTeamWarpsPerSm / W)
    fused_resample_team_day(FusedArgs a) {
  fused_team<W, true>(a);
}

// The selection alone: row r of R, one warp, its N <= 32 V positions in
// registers and its CDF row staged in the warp's shared segment by
// cp.async; the value rows (vals[j][r]) are read in place, which timed
// faster than staging them (scripts/torch_k3_forms.py).
template <int V>
__global__ void __launch_bounds__(256)
    select_kernel(const float* __restrict__ cdf, const float* __restrict__ pos,
                  const float* __restrict__ vals, float* __restrict__ out,
                  int R, int N, int D) {
  extern __shared__ float smem[];
  constexpr int G = V < kSearchGroup ? V : kSearchGroup;
  const int t = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wi;
  if (r >= R) return;
  float* cdf_s = smem + (size_t)wi * round4(N);
  for (int l = t; l < N; l += 32) cp_async4(cdf_s + l, cdf + (size_t)r * N + l);
  float p[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int l = t + 32 * k;
    p[k] = l < N ? pos[(size_t)r * N + l] : 0.0f;
  }
  cp_async_wait_all();
  __syncwarp();
#pragma unroll
  for (int kb = 0; kb < V; kb += G) {
    float q[G];
    bool live[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      q[g] = p[kb + g];
      live[g] = t + 32 * (kb + g) < N;
    }
    int m[G];
    search_slots(cdf_s, N, q, live, m);
    for (int j = 0; j < D; ++j) {
      const size_t at = ((size_t)j * R + r) * N;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (live[g]) out[at + t + 32 * (kb + g)] = vals[at + m[g]];
      }
    }
  }
}

// The launchers' fixed table by V (P = 32 V lanes), from
// scripts/torch_k3_forms.py on an NVIDIA H100 (PERF.md §6): K3 runs
// one warp a chain up to 256 lanes, 8 chains a block up to 128 lanes and
// 2 at 256, and the team form from 512 lanes on, where one warp would
// hold 80 to 128 registers and fewer than 24 warps fit an SM.
__host__ constexpr bool k3_team_form(int v) { return v >= 16; }
__host__ constexpr int k3_warps_per_block(int v) { return v <= 4 ? 8 : 2; }
// bssm_select: one warp a row, 2 rows a block.
constexpr int kSelectWarpsPerBlock = 2;

__host__ inline int lanes_v(int n) {
  int v = 1;
  while (32 * v < n) v <<= 1;
  return v;
}

// Chains a block of the warp form, halved until a block's segments fit.
__host__ inline int fitting_warps(int wpb, size_t seg_bytes) {
  while (wpb > 1 && seg_bytes * wpb > (size_t)kMaxSharedBytes) wpb >>= 1;
  return wpb;
}

template <class Kernel>
cudaError_t launch_blocks(Kernel kernel, int blocks, int threads, size_t smem,
                          cudaStream_t stream, const void* const* args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(threads),
                       const_cast<void**>(args), smem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// One warp a row, `wpb` rows a block, each warp `seg_bytes` of shared
// memory.
template <class Kernel>
cudaError_t launch_warps(Kernel kernel, int rows, int wpb, size_t seg_bytes,
                         cudaStream_t stream, const void* const* args) {
  wpb = fitting_warps(wpb, seg_bytes);
  return launch_blocks(kernel, (rows + wpb - 1) / wpb, 32 * wpb,
                       seg_bytes * wpb, stream, args);
}

template <int V, bool kDay>
cudaError_t launch_fused_vd(const FusedArgs& a, int wpb, bool stage,
                            cudaStream_t stream) {
  const void* args[] = {&a};
  const size_t row_bytes = sizeof(float) * fused_segment(32 * V, a.N * a.D,
                                                         true);
  if (stage && row_bytes <= (size_t)kMaxSharedBytes) {
    return launch_warps(warp_kernel<V, true, kDay>(), a.C, wpb, row_bytes,
                        stream, args);
  }
  return launch_warps(warp_kernel<V, false, kDay>(), a.C, wpb,
                      sizeof(float) * fused_segment(32 * V, 0, false), stream,
                      args);
}

// The engine's day (FusedArgs::ll_out given) takes its own kernels.
template <int V>
cudaError_t launch_fused_v(const FusedArgs& a, int wpb, bool stage,
                           cudaStream_t stream) {
  return a.ll_out != nullptr ? launch_fused_vd<V, true>(a, wpb, stage, stream)
                             : launch_fused_vd<V, false>(a, wpb, stage, stream);
}

// K3's warp form with `wpb` chains a block, the particle row staged in
// shared memory where `stage` asks and it fits, else gathered in place.
inline cudaError_t launch_fused_warp(const FusedArgs& a, int wpb, bool stage,
                                     cudaStream_t stream) {
  switch (lanes_v(a.N)) {
    case 1: return launch_fused_v<1>(a, wpb, stage, stream);
    case 2: return launch_fused_v<2>(a, wpb, stage, stream);
    case 4: return launch_fused_v<4>(a, wpb, stage, stream);
    case 8: return launch_fused_v<8>(a, wpb, stage, stream);
    case 16: return launch_fused_v<16>(a, wpb, stage, stream);
    default: return launch_fused_v<32>(a, wpb, stage, stream);
  }
}

// Shared bytes of a team block: the staged row, the CDF, two exchange
// buffers, the ancestors and each warp's last alive lane.
__host__ constexpr size_t team_bytes(int w, int nd) {
  return sizeof(float) * (size_t)(round4(nd) + 4 * 128 * w) +
         sizeof(int) * (size_t)w;
}

template <int W>
cudaError_t launch_team(const FusedArgs& a, cudaStream_t stream) {
  const void* args[] = {&a};
  const size_t smem = team_bytes(W, a.N * a.D);
  return a.ll_out != nullptr
             ? launch_blocks(fused_resample_team_day<W>, a.C, 32 * W, smem,
                             stream, args)
             : launch_blocks(fused_resample_team<W>, a.C, 32 * W, smem,
                             stream, args);
}

// K3's team form (lane bounds of 256 and more); a row too long for a
// team block's shared memory takes the warp form, staged where it fits.
inline cudaError_t launch_fused_team(const FusedArgs& a, cudaStream_t stream) {
  const int w = lanes_v(a.N) / 4;
  if (w < 2) return cudaErrorInvalidValue;
  if (team_bytes(w, a.N * a.D) > (size_t)kMaxSharedBytes) {
    return launch_fused_warp(a, k3_warps_per_block(lanes_v(a.N)), true,
                             stream);
  }
  switch (w) {
    case 2: return launch_team<2>(a, stream);
    case 4: return launch_team<4>(a, stream);
    default: return launch_team<8>(a, stream);
  }
}

// The staged warp form and the team form, for bssm_fused_resample_info.
template <int V>
const void* warp_fn(int day) {
  return day ? (const void*)fused_resample_day<V, true>
             : (const void*)fused_resample_kernel<V, true>;
}
template <int W>
const void* team_fn(int day) {
  return day ? (const void*)fused_resample_team_day<W>
             : (const void*)fused_resample_team<W>;
}

// K3 as the fixed table sends it.
inline cudaError_t launch_fused(const FusedArgs& a, cudaStream_t stream) {
  const int v = lanes_v(a.N);
  return k3_team_form(v) ? launch_fused_team(a, stream)
                         : launch_fused_warp(a, k3_warps_per_block(v), true,
                                             stream);
}

template <int V>
cudaError_t launch_select_v(const float* cdf, const float* pos,
                            const float* vals, float* out, int R, int N, int D,
                            int wpb, cudaStream_t stream) {
  const void* args[] = {&cdf, &pos, &vals, &out, &R, &N, &D};
  return launch_warps(select_kernel<V>, R, wpb, sizeof(float) * round4(N),
                      stream, args);
}

// bssm_select with `wpb` rows a block.
inline cudaError_t launch_select(const float* cdf, const float* pos,
                                 const float* vals, float* out, int R, int N,
                                 int D, int wpb, cudaStream_t stream) {
  switch (lanes_v(N)) {
    case 1: return launch_select_v<1>(cdf, pos, vals, out, R, N, D, wpb, stream);
    case 2: return launch_select_v<2>(cdf, pos, vals, out, R, N, D, wpb, stream);
    case 4: return launch_select_v<4>(cdf, pos, vals, out, R, N, D, wpb, stream);
    case 8: return launch_select_v<8>(cdf, pos, vals, out, R, N, D, wpb, stream);
    case 16:
      return launch_select_v<16>(cdf, pos, vals, out, R, N, D, wpb, stream);
    default:
      return launch_select_v<32>(cdf, pos, vals, out, R, N, D, wpb, stream);
  }
}

}  // namespace bssm

extern "C" {

// C chains of N <= 1024 lanes and D state columns laid out [C, N, D].
// method: -1 takes `pos` [C, N]; 0/1/2 draw stratified/systematic/
// multinomial positions from `words` (each chain's two uint32 key words in
// int64, rows `word_stride` apart) and `alive` [C]. With `ll_out`, the
// launch is the engine's whole day (the FusedArgs note): `alive`, `ll_in`,
// `dead`, `log_n` and `ess_rec` [C] are then required, `est` [C, D] is
// optional, and `lw` holds the raw log-weights.
int bssm_fused_resample(const float* lw, const float* parts, const float* pos,
                        const float* uni, const float* thr,
                        const long long* words, long long word_stride,
                        const float* alive, float* pout, float* wout,
                        float* ess, float* lse, const float* ll_in,
                        float* ll_out, bool* dead, const float* log_n,
                        float* ess_rec, float* est, int C, int N, int D,
                        int method, int always, void* stream) {
  if (C < 1 || N < 1 || N > 1024 || D < 1 || method < -1 || method > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (method == -1 ? pos == nullptr : (words == nullptr || alive == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (ll_out != nullptr &&
      (alive == nullptr || ll_in == nullptr || dead == nullptr ||
       log_n == nullptr || ess_rec == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bssm::FusedArgs a{lw,    parts, pos,   uni,    thr,     words,
                          word_stride,  alive, pout,   wout,    ess,
                          lse,   ll_in, ll_out, dead,  log_n,   ess_rec,
                          est,   C,     N,     D,      method,  always};
  return (int)bssm::launch_fused(a, (cudaStream_t)stream);
}

// Registers per thread and resident warps per SM of K3 at n lanes and d
// columns, in the form and block the launcher picks, for the step alone
// (day 0) or the engine's day (day 1).
int bssm_fused_resample_info(int n, int d, int day, int* regs,
                             int* warps_per_sm) {
  if (n < 1 || n > 1024 || d < 1) return (int)cudaErrorInvalidValue;
  const int v = bssm::lanes_v(n);
  const void* fn = nullptr;
  int warps = 0;
  size_t smem = 0;
  if (bssm::k3_team_form(v) &&
      bssm::team_bytes(v / 4, n * d) <= (size_t)bssm::kMaxSharedBytes) {
    warps = v / 4;
    smem = bssm::team_bytes(warps, n * d);
    fn = v == 16 ? bssm::team_fn<4>(day) : bssm::team_fn<8>(day);
  } else {
    const size_t seg =
        sizeof(float) * (size_t)bssm::fused_segment(32 * v, n * d, true);
    warps = bssm::fitting_warps(bssm::k3_warps_per_block(v), seg);
    smem = seg * warps;
    switch (v) {
      case 1: fn = bssm::warp_fn<1>(day); break;
      case 2: fn = bssm::warp_fn<2>(day); break;
      case 4: fn = bssm::warp_fn<4>(day); break;
      case 8: fn = bssm::warp_fn<8>(day); break;
      case 16: fn = bssm::warp_fn<16>(day); break;
      default: fn = bssm::warp_fn<32>(day);
    }
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * warps,
                                                      smem);
  *warps_per_sm = blocks * warps;
  return (int)err;
}

// The selection alone, over R rows of N <= 1024 lanes and D value columns
// laid out [D, R, N].
int bssm_select(const float* cdf, const float* pos, const float* vals,
                float* out, int R, int N, int D, void* stream) {
  if (R < 1 || N < 1 || N > 1024 || D < 1) return (int)cudaErrorInvalidValue;
  return (int)bssm::launch_select(cdf, pos, vals, out, R, N, D,
                                  bssm::kSelectWarpsPerBlock,
                                  (cudaStream_t)stream);
}

}  // extern "C"
