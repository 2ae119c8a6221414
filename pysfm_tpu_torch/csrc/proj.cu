// Fused residual + analytic Jacobian + IRLS weight, component-major output.
//
// Replaces the Pallas TPU kernel pysfm_tpu/solver/kernels/pallas_proj.py
// (residuals_jacobians_weights_cm and, through the wrapper's transposes,
// residuals_jacobians_weights).  Per observation m it writes
//   rt  [2, M]      residual
//   Jct [2*CP, M]   camera Jacobian, row i*CP + d, zero for fixed cameras
//   Jpt [6, M]      point Jacobian, row i*3 + s
//   wt  [M]         obs_w * rho'(||r||^2)
//
// Design for Hopper (not a translation of the Pallas blocks):
// - one thread per observation, 256 threads a block, the ragged edge masked;
//   no tile padding and no z = 1 pad lanes;
// - the kernel gathers R, t, intr, free by obs_cam and X by obs_pt itself
//   from int32 indices: the camera table and the points stay L2-resident
//   (50 MB), so the [M, .] gathered operands the JAX route materializes
//   never touch device memory;
// - every output is [D, M]: thread m writes column m of each row, so the
//   stores of a warp are 128-byte coalesced;
// - no shared memory, no atomics: the result is bitwise deterministic.
//
// Bound on the H100 SXM (3.35 TB/s): per observation the kernel reads about
// 32 B from DRAM (obs_cam, obs_pt, uv, w, and the point on first touch) and
// writes 84 B (pose), 108 B (bal) or 116 B (pose_k).  At M ~ 164k that is
// ~19 MB, ~6 us of DRAM time, so at that size the kernel is bound by its
// launch and one wave of blocks rather than by bandwidth.  The measured
// time is in PERF.md.
//
// C entry: pysfm_proj_cm, called through ctypes.  It launches on the given
// stream, allocates nothing, does not synchronize, and returns
// cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include "project_jac.cuh"

namespace pysfm {

constexpr int kThreads = 256;

template <int MODEL, int ROBUST>
__global__ void __launch_bounds__(kThreads)
proj_cm_kernel(const float* __restrict__ R,        // [C, 9]
               const float* __restrict__ t,        // [C, 3]
               const float* __restrict__ intr,     // [C, INTR]
               const float* __restrict__ X,        // [P, 3]
               const int32_t* __restrict__ obs_cam,  // [M]
               const int32_t* __restrict__ obs_pt,   // [M]
               const float* __restrict__ uv,       // [M, 2]
               const float* __restrict__ w,        // [M]
               const float* __restrict__ free_c,   // [C] 1 free, 0 fixed
               const float* __restrict__ scale,    // [1] robust knee
               int M,
               float* __restrict__ rt,             // [2, M]
               float* __restrict__ Jct,            // [2*CP, M]
               float* __restrict__ Jpt,            // [6, M]
               float* __restrict__ wt) {           // [M]
  constexpr int CP = ModelTraits<MODEL>::CP;
  constexpr int NI = ModelTraits<MODEL>::INTR;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t Ms = static_cast<size_t>(M);

  const int c = __ldg(obs_cam + m);
  const int p = __ldg(obs_pt + m);
  float Rl[9], tl[3], il[NI], Xl[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Rl[k] = __ldg(R + 9 * static_cast<size_t>(c) + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) tl[k] = __ldg(t + 3 * static_cast<size_t>(c) + k);
#pragma unroll
  for (int k = 0; k < NI; ++k) il[k] = __ldg(intr + NI * static_cast<size_t>(c) + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) Xl[k] = __ldg(X + 3 * static_cast<size_t>(p) + k);
  const float u_obs = __ldg(uv + 2 * static_cast<size_t>(m));
  const float v_obs = __ldg(uv + 2 * static_cast<size_t>(m) + 1);

  ProjJac<MODEL> o;
  project_jac<MODEL>(Rl, tl, il, Xl, u_obs, v_obs, o);

  rt[m] = o.r[0];
  rt[Ms + m] = o.r[1];
  const float s = o.r[0] * o.r[0] + o.r[1] * o.r[1];
  wt[m] = __ldg(w + m) * robust_weight<ROBUST>(s, __ldg(scale));

  const float fm = __ldg(free_c + c);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < CP; ++d) Jct[(i * CP + d) * Ms + m] = fm * o.Jc[i][d];
#pragma unroll
    for (int k = 0; k < 3; ++k) Jpt[(i * 3 + k) * Ms + m] = o.Jp[i][k];
  }
}

template <int MODEL, int ROBUST>
void launch(const void* const* in, int M, void* const* out, cudaStream_t stream) {
  const int blocks = (M + kThreads - 1) / kThreads;
  proj_cm_kernel<MODEL, ROBUST><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const int32_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]), M,
      static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]));
}

template <int MODEL>
bool launch_robust(int robust, const void* const* in, int M, void* const* out,
                   cudaStream_t stream) {
  switch (robust) {
    case ROBUST_GAUSSIAN: launch<MODEL, ROBUST_GAUSSIAN>(in, M, out, stream); return true;
    case ROBUST_HUBER:    launch<MODEL, ROBUST_HUBER>(in, M, out, stream); return true;
    case ROBUST_CAUCHY:   launch<MODEL, ROBUST_CAUCHY>(in, M, out, stream); return true;
    default: return false;
  }
}

}  // namespace pysfm

extern "C" cudaError_t pysfm_proj_cm(int model, int robust,
                                     const void* R, const void* t, const void* intr,
                                     const void* X, const void* obs_cam,
                                     const void* obs_pt, const void* uv, const void* w,
                                     const void* free_c, const void* scale, int M,
                                     void* rt, void* Jct, void* Jpt, void* wt,
                                     void* stream) {
  using namespace pysfm;
  if (M <= 0) return cudaErrorInvalidValue;
  const void* in[10] = {R, t, intr, X, obs_cam, obs_pt, uv, w, free_c, scale};
  void* out[4] = {rt, Jct, Jpt, wt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (model) {
    case MODEL_POSE:   ok = launch_robust<MODEL_POSE>(robust, in, M, out, s); break;
    case MODEL_POSE_K: ok = launch_robust<MODEL_POSE_K>(robust, in, M, out, s); break;
    case MODEL_BAL:    ok = launch_robust<MODEL_BAL>(robust, in, M, out, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
