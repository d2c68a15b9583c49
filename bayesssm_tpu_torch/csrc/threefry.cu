// Threefry-2x32 keys and draws of the generic filter engine for Hopper
// (sm_90a): one launch computes a whole split, fold_in, random_bits,
// uniform or normal of bayesssm_tpu_torch/ops/threefry.py for every key,
// or binomial's lane uniforms (_lane_uniforms) for every key and lane.
//
// Replaces no Pallas kernel: the JAX package draws these through
// jax.random, which XLA lowers to threefry elementwise code
// (jax/_src/prng.py::_threefry2x32_lowering). The plain twin is
// ops/threefry.py itself, which computes a normal as ~250 PyTorch
// elementwise ops (20 rounds of in-place int32 ops, then erfinv's float64
// steps), each reading and writing the whole [R, n] tensor. Here the block
// function and the draw's output form run in registers and only the
// result is written.
//
// Bit for bit with the plain twin on the card:
// * the block function on uint32 words (rotations by __funnelshift_l; the
//   plain twin's masked arithmetic shift gives the same bits);
// * the counter of flat index i of the draw's shape is (i >> 32, i mod
//   2^32), and the wrapper keeps i below 2^31, so the high word is 0;
//   fold_in's and the lane uniforms' counter is (0, data), a lane index
//   below 2^32 for the latter;
// * _fma(a, b, c) of the plain twin is a float64 product of two float32
//   values, which is exact, a float64 add and one rounding to float32; a
//   float64 fma of the same values rounds once at the same point, so
//   __fma_rn gives the same bits with half the float64 instructions;
// * uniform's floor at minval is ATen's clamp_min: NaN stays, else fmaxf;
//   at minval 0 and span 1 the multiply-add returns the fill unchanged
//   (exact), so the plain twin's shortcut there is the same value;
// * erfinv calls log1pf and sqrtf, as ATen's CUDA log1p and sqrt do; the
//   library is built without fast math and with --fmad=false (ops/
//   _build.py), so no float32 multiply and add contract.
//
// What bounds it on this card: operations, not bytes. A normal is ~75
// integer instructions of the block function, ~40 float32 ones (the fill,
// log1pf, sqrtf, the selections) and 9 float64 fmas, and writes 4 bytes;
// its ~21 MUFU operations and float32 <-> float64 conversions (16 a clock
// on an SM) bind just ahead of instruction issue (128 a clock). Layout:
// a flat grid over the R x n outputs, kThreads a block, kPer consecutive
// outputs a thread (one 16-byte store of four floats), no shared memory
// and no barrier, so that many warps stay resident to hide the float64
// and log1pf latency.
#include <cuda_runtime.h>

#include <cstdint>

namespace bssm {
namespace threefry {

constexpr int kThreads = 256;
constexpr int kPer = 4;

// Forms, as ops/_build.py::THREEFRY_FORMS numbers them.
constexpr int kSplit = 0;
constexpr int kFoldIn = 1;
constexpr int kBits = 2;
constexpr int kUniform = 3;
constexpr int kNormal = 4;
constexpr int kLaneUniform = 5;

// The key schedule's parity word (ops/threefry.py: _KS_PARITY).
constexpr uint32_t kParity = 0x1BD11BDAu;
// float32(sqrt(2)) and nextafter(-1, 0) in float32 (_SQRT2_F32,
// _NORMAL_LO), and the normal's uniform span float32(1) - _NORMAL_LO:
// 2 - 2^-24 rounds to the even 2.
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kNormalLo = -0x1.fffffep-1f;
constexpr float kNormalSpan = 0x1p+1f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 20-round block function: counter (x0, x1) in, output words out.
__device__ __forceinline__ void block(uint32_t k0, uint32_t k1, uint32_t& x0,
                                      uint32_t& x1) {
  // Rotations of the even and odd groups of four rounds (_ROTATIONS).
  constexpr int kRotations[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRotations[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// float32 on [0, 1): 23 random mantissa bits under 1.0's exponent, minus 1.
__device__ __forceinline__ float fill(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The plain twin's _fma: round(float64(a) * b + c) to float32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
}

__device__ __forceinline__ float uniform_at(float f, float lo, float span) {
  const float v = fma_f64(f, span, lo);
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float erfinv(float x) {
  // Coefficients for w = -log1p(-x^2) below 5 and from 5 up
  // (_ERFINV_SMALL_W, _ERFINV_LARGE_W), highest power first.
  constexpr float kSmallW[9] = {
      0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
      -0x1.11c9dep-8f, 0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  constexpr float kLargeW[9] = {
      -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
      -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
      0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float w = -log1pf(x * -x);
  const bool small = w < 5.0f;
  w = small ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = small ? kSmallW[0] : kLargeW[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    p = fma_f64(p, w, small ? kSmallW[k] : kLargeW[k]);
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

template <int Form>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const long long* __restrict__ keys, long long key_stride,
                    const long long* __restrict__ data, long long data_stride,
                    uint32_t data_word, void* __restrict__ out, int total,
                    int n, float lo, float span) {
  const long long first =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (first >= total) return;
  const int e0 = (int)first;
  int row = e0 / n;
  int idx = e0 - row * n;
  uint32_t k0 = 0, k1 = 0;
  int key_row = -1;
  float vals[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = e0 + q;
    if (q < total - e0) {
      if (row != key_row) {
        const long long* kw = keys + (long long)row * key_stride;
        k0 = (uint32_t)kw[0];
        k1 = (uint32_t)kw[1];
        key_row = row;
      }
      uint32_t x0 = 0;
      uint32_t x1 = (uint32_t)idx;
      if (Form == kFoldIn || Form == kLaneUniform) {
        x1 = data ? (uint32_t)data[(long long)row * data_stride] : data_word;
      }
      block(k0, k1, x0, x1);
      if (Form == kSplit || Form == kFoldIn) {
        reinterpret_cast<longlong2*>(out)[e] =
            make_longlong2((long long)x0, (long long)x1);
      } else if (Form == kBits) {
        reinterpret_cast<long long*>(out)[e] = (long long)(x0 ^ x1);
      } else if (Form == kUniform) {
        vals[q] = uniform_at(fill(x0 ^ x1), lo, span);
      } else if (Form == kLaneUniform) {
        vals[q] = fill(x0 ^ x1);
      } else {
        vals[q] = kSqrt2 *
                  erfinv(uniform_at(fill(x0 ^ x1), kNormalLo, kNormalSpan));
      }
    }
    if (++idx == n) {
      idx = 0;
      ++row;
    }
  }
  if (Form == kUniform || Form == kNormal || Form == kLaneUniform) {
    float* o = reinterpret_cast<float*>(out);
    if (total - e0 >= kPer) {
      *reinterpret_cast<float4*>(o + e0) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (q < total - e0) o[e0 + q] = vals[q];
      }
    }
  }
}

template <int Form>
int launch(const long long* keys, long long key_stride,
           const long long* data, long long data_stride, uint32_t data_word,
           void* out, int total, int n, float lo, float span,
           cudaStream_t stream) {
  const int threads = (total + kPer - 1) / kPer;
  const int blocks = (threads + kThreads - 1) / kThreads;
  threefry_kernel<Form><<<blocks, kThreads, 0, stream>>>(
      keys, key_stride, data, data_stride, data_word, out, total, n, lo,
      span);
  return (int)cudaGetLastError();
}

}  // namespace threefry
}  // namespace bssm

extern "C" {

// R rows of key words keys[r * key_stride + {0, 1}] (uint32 values in
// int64), n outputs a row, R * n < 2^31; out is int64 [R, n, 2] (split),
// [R, 2] (fold_in, n = 1: counter (0, data[r * data_stride]), or (0,
// data_word) when data is null), int64 [R, n] (random bits) or float32
// [R, n] (uniform on [lo, lo + span), normal; the lane uniforms, n = 1, at
// fold_in's counter), 16-byte aligned.
int bssm_threefry(const long long* keys, long long key_stride,
                  const long long* data, long long data_stride,
                  unsigned int data_word, void* out, int rows, int n,
                  int form, float lo, float span, void* stream) {
  namespace tf = bssm::threefry;
  if (rows < 1 || n < 1 || (long long)rows * n >= (1LL << 31) ||
      ((form == tf::kFoldIn || form == tf::kLaneUniform) && n != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = rows * n;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case tf::kSplit:
      return tf::launch<tf::kSplit>(keys, key_stride, data, data_stride,
                                    data_word, out, total, n, lo, span, s);
    case tf::kFoldIn:
      return tf::launch<tf::kFoldIn>(keys, key_stride, data, data_stride,
                                     data_word, out, total, n, lo, span, s);
    case tf::kBits:
      return tf::launch<tf::kBits>(keys, key_stride, data, data_stride,
                                   data_word, out, total, n, lo, span, s);
    case tf::kUniform:
      return tf::launch<tf::kUniform>(keys, key_stride, data, data_stride,
                                      data_word, out, total, n, lo, span, s);
    case tf::kNormal:
      return tf::launch<tf::kNormal>(keys, key_stride, data, data_stride,
                                     data_word, out, total, n, lo, span, s);
    case tf::kLaneUniform:
      return tf::launch<tf::kLaneUniform>(keys, key_stride, data,
                                          data_stride, data_word, out, total,
                                          n, lo, span, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
