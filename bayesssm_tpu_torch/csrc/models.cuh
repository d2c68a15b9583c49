// Model functors of the whole-sweep kernel, and the SIR day loop it shares
// with the Gillespie day-step kernel (gillespie.cu): the device copies of
// the sweep callbacks in bayesssm_tpu_torch/ops/sir_sweep.py and
// ops/lgss_sweep.py (JAX: ops/sir_sweep_pallas.py::sir_sweep_parts and
// ops/lgss_sweep_pallas.py::_lgss_op). Each thread holds one particle's
// state in registers. Expressions keep the plain version's evaluation
// order; the library is built with --fmad=false so none is contracted.
//
// A functor declares D (state columns), P (parameters), DY (observation
// columns), init, transition and log_weight. kHasAux marks an APF
// lookahead aux_log_weight, kHasMove an RMPF move(rng, st, th, y_t); the
// sweep compiles those stages in only for functors that have them.
#pragma once

#include "reduce.cuh"
#include "rng.cuh"

namespace bssm {

constexpr int kMaxEvents = 100000;  // ops/gillespie_pallas.py:52
// float32(0.5 * log(2 pi)), the Gaussian weights' constant.
constexpr float kHalfLog2Pi = 0.918938533204672742f;

// Attempts a lane may run in one call: the JAX loop's event cap rounded up
// to whole groups of `unroll`.
__host__ __device__ constexpr int event_cap(int unroll) {
  return unroll * ((kMaxEvents + unroll - 1) / unroll);
}

// The serial step of one attempt of the exact SIR jump process (the event
// body of the JAX package's SIR sweep callback, ops/sir_sweep_pallas.py:
// 119-133, and of its Gillespie day-step kernel, ops/gillespie_pallas.py:
// 159-174) given its draws: neg_log = -log1pf(-u0) and u1. Returns whether
// the lane is still active (the event fell inside [0, t_end] and I > 0).
// One division; a rate of 0 gives an inf or NaN time that fails the
// `t_end` test, as in the plain version.
__device__ __forceinline__ bool sir_event(float neg_log, float u1, float& s,
                                          float& i, float& tloc, float lam_n,
                                          float gam, float t_end) {
  const float rate_inf = lam_n * s * i;
  const float rate_tot = rate_inf + gam * i;
  const float t_new = tloc + neg_log * (1.0f / rate_tot);
  const bool fire = t_new <= t_end;
  if (fire) {
    if (u1 * rate_tot < rate_inf) {
      s = s - 1.0f;
      i = i + 1.0f;
    } else {
      i = i - 1.0f;
    }
    tloc = t_new;
  }
  return fire && i > 0.0f;
}

// The SIR jump process over [0, t_end] for one lane, with no barrier: the
// lane runs attempts while it is active and below `cap`; attempt a draws
// counters ctr0 + 2a (its waiting time) and ctr0 + 2a + 1 (its event).
// Returns the attempts it ran, the one that ended it included.
//
// This equals the JAX loop, which runs a chain's lanes together in groups
// of `unroll` attempts while any lane is active: a lane that is not active
// never fires again, and group g draws counters ctr0 + 2 unroll g onward
// whatever the other lanes do. So the lane's state depends on its own key,
// state and rates alone, and the chain's counter after the day is
// ctr0 + 2 unroll max_l ceil(attempts_l / unroll) (tests/
// test_torch_gillespie_lanes.py holds both on the plain version).
__device__ __forceinline__ int sir_lane(const Rng& rng, int ctr0, float& s,
                                        float& i, float lam_n, float gam,
                                        float t_end, int cap) {
  float tloc = 0.0f;
  bool active = i > 0.0f;
  int a = 0;
  while (active && a < cap) {
    const int k = ctr0 + 2 * a;
    active = sir_event(-log1pf(-rng.uniform_at(k)), rng.uniform_at(k + 1), s,
                       i, tloc, lam_n, gam, t_end);
    ++a;
  }
  return a;
}

// Poisson log-pmf of y_t[0] at rate i, with lgamma(y + 1) = y_t[1] and
// i = 0 exact.
__device__ __forceinline__ float pois_lw(float i, const float* y_t) {
  const float y = y_t[0];
  const float safe_i = i > 0.0f ? i : 1.0f;
  const float lw = y * logf(safe_i) - i - y_t[1];
  return i > 0.0f ? lw : (y == 0.0f ? 0.0f : -1e30f);
}

// Stochastic SIR: state (S, I), parameters (lam, gamma), observation row
// (y, lgamma(y + 1)).
struct SirModel {
  static constexpr int D = 2;
  static constexpr int P = 2;
  static constexpr int DY = 2;
  static constexpr bool kHasAux = true;
  static constexpr bool kHasMove = true;
  float inv_nt;  // float32(1 / n_total)
  float s0;
  float i0;
  int unroll;
  int move_step_max;

  __device__ void init(Rng&, float st[D], const float*) const {
    st[0] = s0;
    st[1] = i0;
  }

  // One exact Gillespie day over [0, 1]: every lane runs sir_lane on its
  // own (masked lanes too, as in the plain sweep), then one block max of
  // the groups run moves the chain's counter as the JAX loop does. Every
  // thread of the block must call it.
  __device__ void transition(Rng& rng, float st[D], const float* th,
                             int) const {
    const int a = sir_lane(rng, rng.ctr, st[0], st[1], th[0] * inv_nt,
                           th[1], 1.0f, event_cap(unroll));
    rng.ctr += 2 * unroll * block_max_int((a + unroll - 1) / unroll);
  }

  // Poisson log-pmf in I, with I = 0 exact.
  __device__ float log_weight(const float st[D], const float*,
                              const float* y_t) const {
    return pois_lw(st[1], y_t);
  }

  // The APF lookahead is the observation density itself.
  __device__ float aux_log_weight(const float st[D], const float* th,
                                  const float* y_t) const {
    return log_weight(st, th, y_t);
  }

  // RMPF move (ops/sir_sweep_pallas.py:161-179): two draws per lane;
  // I' = I + floor(u0 * (2k + 1)) - k is kept when it lies in
  // [0, n_total - S] and log(u1) is below the likelihood ratio.
  __device__ void move(Rng& rng, float st[D], const float*,
                       const float* y_t) const {
    const float u0 = rng.uniform_at(rng.ctr);
    const float u1 = rng.uniform_at(rng.ctr + 1);
    rng.ctr += 2;
    const float s = st[0];
    const float i = st[1];
    const float step =
        floorf(u0 * (float)(2 * move_step_max + 1)) - (float)move_step_max;
    const float i_prop = i + step;
    const float n_total = s0 + i0;  // integers below 2^24: exact
    const bool in_support = i_prop >= 0.0f && i_prop <= n_total - s;
    const float log_ratio =
        pois_lw(fmaxf(i_prop, 0.0f), y_t) - pois_lw(i, y_t);
    if (in_support && logf(u1) < log_ratio) st[1] = i_prop;
  }
};

// Linear-Gaussian SSM: state x, parameters (a, sigma_x, sigma_y).
struct LgssModel {
  static constexpr int D = 1;
  static constexpr int P = 3;
  static constexpr int DY = 1;
  static constexpr bool kHasAux = false;
  static constexpr bool kHasMove = false;
  float c;
  float p0;

  __device__ void init(Rng& rng, float st[D], const float*) const {
    st[0] = p0 * rng.normal();
  }

  __device__ void transition(Rng& rng, float st[D], const float* th,
                             int) const {
    st[0] = th[0] * st[0] + th[1] * rng.normal();
  }

  __device__ float log_weight(const float st[D], const float* th,
                              const float* y_t) const {
    const float resid = (y_t[0] - c * st[0]) / th[2];
    return -0.5f * resid * resid - logf(th[2]) - kHalfLog2Pi;
  }
};

// Vector-observation LGSS (ops/lgss_sweep.py::_lgss_mv_op): state x,
// parameters (a, sigma_x, sigma_y1, sigma_y2), observation row (y1, y2) =
// (c1, c2) x + independent Gaussian noise.
struct LgssMvModel {
  static constexpr int D = 1;
  static constexpr int P = 4;
  static constexpr int DY = 2;
  static constexpr bool kHasAux = false;
  static constexpr bool kHasMove = false;
  float c1;
  float c2;
  float p0;

  __device__ void init(Rng& rng, float st[D], const float*) const {
    st[0] = p0 * rng.normal();
  }

  __device__ void transition(Rng& rng, float st[D], const float* th,
                             int) const {
    st[0] = th[0] * st[0] + th[1] * rng.normal();
  }

  __device__ float log_weight(const float st[D], const float* th,
                              const float* y_t) const {
    const float r1 = (y_t[0] - c1 * st[0]) / th[2];
    const float r2 = (y_t[1] - c2 * st[0]) / th[3];
    return -0.5f * (r1 * r1 + r2 * r2) - logf(th[2]) - logf(th[3]) -
           2.0f * kHalfLog2Pi;
  }
};

// The README's sinusoidal model (models/sinusoidal.py): x_0 ~ N(0, 1),
// x_t = phi x + sin(x) + sigma_x eps, y_t ~ N(x_t, sigma_y^2); parameters
// (phi, sigma_x, sigma_y), no model constants.
struct SinusoidalModel {
  static constexpr int D = 1;
  static constexpr int P = 3;
  static constexpr int DY = 1;
  static constexpr bool kHasAux = false;
  static constexpr bool kHasMove = false;

  __device__ void init(Rng& rng, float st[D], const float*) const {
    st[0] = rng.normal();
  }

  // sinf is the accurate one (no fast math), as torch.sin on CUDA calls it.
  __device__ void transition(Rng& rng, float st[D], const float* th,
                             int) const {
    const float x = st[0];
    st[0] = th[0] * x + sinf(x) + th[1] * rng.normal();
  }

  __device__ float log_weight(const float st[D], const float* th,
                              const float* y_t) const {
    const float r = (y_t[0] - st[0]) / th[2];
    return -0.5f * r * r - logf(th[2]) - kHalfLog2Pi;
  }
};

}  // namespace bssm
