// The zoo's whole-sweep entries: the kernel template of sweep.cuh
// instantiated with each functor of models.cuh (SIR, LGSS, LGSS-mv,
// sinusoidal). Functors generated from a user's callbacks get entries of
// their own (ops/_build.py::build_generated); the selection alone
// (bssm_select) is in resample.cu.
#include "sweep.cuh"

extern "C" {

// gaps/times: per-observation transition counts and their running sums
// (int32 [T] each), or both null for one transition a day. algorithm: 0
// BPF, 1 APF, 2 RMPF.
int bssm_sweep_sir(const int* seeds, const float* y, const float* theta,
                   const float* alive, const float* thr, float* ll,
                   float* est, const int* gaps, const int* times, int C,
                   int N, int T, int mode, int systematic, int algorithm,
                   float inv_nt, float s0, float i0, int unroll,
                   int move_step_max, void* stream) {
  if (unroll < 1 || move_step_max < 0) return (int)cudaErrorInvalidValue;
  bssm::SirModel model{inv_nt, s0, i0, unroll, move_step_max};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est,
                            gaps, times, C, N, T, mode, systematic,
                            algorithm, (cudaStream_t)stream);
}

// Registers per thread and resident blocks per SM of the SIR sweep kernel
// at n lanes.
int bssm_sweep_sir_info(int n, int* regs, int* blocks_per_sm) {
  using K = bssm::SirModel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bssm::sweep_kernel<K>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bssm::sweep_kernel<K>, n,
      bssm::SweepShared::bytes(n, bssm::Route<K>::kCols));
}

int bssm_sweep_lgss(const int* seeds, const float* y, const float* theta,
                    const float* alive, const float* thr, float* ll,
                    float* est, const int* gaps, const int* times, int C,
                    int N, int T, int mode, int systematic, int algorithm,
                    float c, float p0, void* stream) {
  bssm::LgssModel model{c, p0};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est,
                            gaps, times, C, N, T, mode, systematic,
                            algorithm, (cudaStream_t)stream);
}

// y: [T, 2] rows; theta: [C, 4] (a, sigma_x, sigma_y1, sigma_y2).
int bssm_sweep_lgss_mv(const int* seeds, const float* y, const float* theta,
                       const float* alive, const float* thr, float* ll,
                       float* est, const int* gaps, const int* times, int C,
                       int N, int T, int mode, int systematic, int algorithm,
                       float c1, float c2, float p0, void* stream) {
  bssm::LgssMvModel model{c1, c2, p0};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est,
                            gaps, times, C, N, T, mode, systematic,
                            algorithm, (cudaStream_t)stream);
}

// theta: [C, 3] (phi, sigma_x, sigma_y); the model has no constants.
int bssm_sweep_sinusoidal(const int* seeds, const float* y,
                          const float* theta, const float* alive,
                          const float* thr, float* ll, float* est,
                          const int* gaps, const int* times, int C, int N,
                          int T, int mode, int systematic, int algorithm,
                          void* stream) {
  bssm::SinusoidalModel model{};
  return bssm::launch_sweep(model, seeds, y, theta, alive, thr, ll, est,
                            gaps, times, C, N, T, mode, systematic,
                            algorithm, (cudaStream_t)stream);
}

}  // extern "C"
