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
// - the kernel gathers R, t, intr, cam_fixed by obs_cam and X by obs_pt
//   itself from int32 indices: the camera table and the points stay
//   L2-resident (50 MB), so the [M, .] gathered operands the JAX route
//   materializes never touch device memory; it reads the problem's own
//   cam_fixed (bool), so a call runs nothing on the card but this kernel
//   (computing f32 free flags per call took two more kernels, ~0.004 ms of
//   a 0.0144 ms headline call on an H100);
// - every output is [D, M].  When M is a multiple of 4 (and the arrays are
//   16-byte aligned) each thread takes 4 consecutive observations: their
//   ids, uv and w arrive in 16-byte loads and each of the D output rows
//   leaves in one 16-byte store, so a warp writes 512 contiguous bytes of a
//   row at once (0.207 ms against 0.242 ms with one observation a thread at
//   Venice's M on an H100: chip_smoke.py [proj venice]).  Otherwise one
//   observation a thread, each row store 128-byte coalesced across the
//   warp.  Both compute each observation with the same code; the compiler
//   may contract other multiply-adds in the two instantiations (the bal
//   model's outputs differ in the last bits), so each is held to the plain
//   version;
// - no shared memory, no atomics: the result is bitwise deterministic.
//
// Bound on the H100 SXM (3.35 TB/s): per observation the kernel reads about
// 20 B (obs_cam, obs_pt, uv, w; the tables once) and writes 84 B (pose),
// 108 B (bal) or 116 B (pose_k): at Venice's M ~ 5.0M, ~0.52 GB, ~0.16 ms.
// At the headline (M ~ 164k) ~17 MB, ~0.005 ms, about the time of an empty
// kernel: there the kernel is one wave of blocks and its launch.  Measured
// times are in PERF.md.
//
// C entry: pysfm_proj_cm, called through ctypes.  It launches on the given
// stream, allocates nothing, does not synchronize, and returns
// cudaGetLastError().
#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "project_jac.cuh"

namespace pysfm {

// Observations a thread takes: 1, or 4 as 16-byte vectors.
template <int V> struct ProjVec;
template <> struct ProjVec<1> {
  static constexpr int kThreads = 256;
  __device__ static void ids(const int32_t* a, int g, int (&x)[1]) { x[0] = __ldg(a + g); }
  __device__ static void vals(const float* a, int g, float (&x)[1]) { x[0] = __ldg(a + g); }
  __device__ static void uv(const float* a, int g, float (&u)[1], float (&v)[1]) {
    u[0] = __ldg(a + 2 * static_cast<size_t>(g));
    v[0] = __ldg(a + 2 * static_cast<size_t>(g) + 1);
  }
  __device__ static void store(float* row, int g, const float (&x)[1]) { row[g] = x[0]; }
};
template <> struct ProjVec<4> {
  static constexpr int kThreads = 128;
  __device__ static void ids(const int32_t* a, int g, int (&x)[4]) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(a) + g);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
  __device__ static void vals(const float* a, int g, float (&x)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(a) + g);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
  __device__ static void uv(const float* a, int g, float (&u)[4], float (&v)[4]) {
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(a) + 2 * static_cast<size_t>(g));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(a) + 2 * static_cast<size_t>(g) + 1);
    u[0] = q0.x; v[0] = q0.y; u[1] = q0.z; v[1] = q0.w;
    u[2] = q1.x; v[2] = q1.y; u[3] = q1.z; v[3] = q1.w;
  }
  __device__ static void store(float* row, int g, const float (&x)[4]) {
    reinterpret_cast<float4*>(row)[g] = make_float4(x[0], x[1], x[2], x[3]);
  }
};

// Thread g owns observations V*g .. V*g + V-1 (M is a multiple of V).
template <int MODEL, int ROBUST, int V>
__global__ void __launch_bounds__(ProjVec<V>::kThreads)
proj_cm_kernel(const float* __restrict__ R,        // [C, 9]
               const float* __restrict__ t,        // [C, 3]
               const float* __restrict__ intr,     // [C, INTR]
               const float* __restrict__ X,        // [P, 3]
               const int32_t* __restrict__ obs_cam,  // [M]
               const int32_t* __restrict__ obs_pt,   // [M]
               const float* __restrict__ uv,       // [M, 2]
               const float* __restrict__ w,        // [M]
               const uint8_t* __restrict__ fixed,  // [C] 1 gauge-fixed, 0 free
               const float* __restrict__ scale,    // [1] robust knee
               int M,
               float* __restrict__ rt,             // [2, M]
               float* __restrict__ Jct,            // [2*CP, M]
               float* __restrict__ Jpt,            // [6, M]
               float* __restrict__ wt) {           // [M]
  using Vec = ProjVec<V>;
  constexpr int CP = ModelTraits<MODEL>::CP;
  constexpr int NI = ModelTraits<MODEL>::INTR;
  constexpr int D = 3 + 2 * CP + 6;  // rt, wt, Jct, Jpt rows
  const int g = blockIdx.x * Vec::kThreads + threadIdx.x;
  if (g >= M / V) return;
  const size_t Ms = static_cast<size_t>(M);

  int cam[V], pt[V];
  float u_obs[V], v_obs[V], w_obs[V];
  Vec::ids(obs_cam, g, cam);
  Vec::ids(obs_pt, g, pt);
  Vec::uv(uv, g, u_obs, v_obs);
  Vec::vals(w, g, w_obs);
  const float sc = __ldg(scale);

  float out[D][V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const size_t c = static_cast<size_t>(cam[q]);
    const size_t p = static_cast<size_t>(pt[q]);
    float Rl[9], tl[3], il[NI], Xl[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rl[k] = __ldg(R + 9 * c + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) tl[k] = __ldg(t + 3 * c + k);
#pragma unroll
    for (int k = 0; k < NI; ++k) il[k] = __ldg(intr + NI * c + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) Xl[k] = __ldg(X + 3 * p + k);
    const float fm = __ldg(fixed + c) ? 0.0f : 1.0f;

    ProjJac<MODEL> o;
    project_jac<MODEL>(Rl, tl, il, Xl, u_obs[q], v_obs[q], o);
    const float s = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    out[0][q] = o.r[0];
    out[1][q] = o.r[1];
    out[2][q] = w_obs[q] * robust_weight<ROBUST>(s, sc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int d = 0; d < CP; ++d) out[3 + i * CP + d][q] = fm * o.Jc[i][d];
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 + 2 * CP + i * 3 + k][q] = o.Jp[i][k];
    }
  }
  Vec::store(rt, g, out[0]);
  Vec::store(rt + Ms, g, out[1]);
  Vec::store(wt, g, out[2]);
#pragma unroll
  for (int r = 0; r < 2 * CP; ++r) Vec::store(Jct + r * Ms, g, out[3 + r]);
#pragma unroll
  for (int r = 0; r < 6; ++r) Vec::store(Jpt + r * Ms, g, out[3 + 2 * CP + r]);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int MODEL, int ROBUST, int V>
void launch_v(const void* const* in, int M, void* const* out, cudaStream_t stream) {
  constexpr int threads = ProjVec<V>::kThreads;
  const int groups = M / V;
  proj_cm_kernel<MODEL, ROBUST, V><<<(groups + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const int32_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const uint8_t*>(in[8]), static_cast<const float*>(in[9]), M,
      static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]));
}

// vec_mode -1: 4 observations a thread where M % 4 == 0 and the vector
// operands are 16-byte aligned, else 1; 1: 4 (cudaErrorInvalidValue where
// that does not hold); 0: 1.
template <int MODEL, int ROBUST>
cudaError_t launch(const void* const* in, int M, int vec_mode, void* const* out,
                   cudaStream_t stream) {
  bool vec_ok = M % 4 == 0;
  for (const void* p : {in[4], in[5], in[6], in[7], static_cast<const void*>(out[0]),
                        static_cast<const void*>(out[1]), static_cast<const void*>(out[2]),
                        static_cast<const void*>(out[3])}) {
    vec_ok = vec_ok && aligned16(p);
  }
  if (vec_mode == 1 && !vec_ok) return cudaErrorInvalidValue;
  if (vec_mode == 1 || (vec_mode == -1 && vec_ok)) {
    launch_v<MODEL, ROBUST, 4>(in, M, out, stream);
  } else {
    launch_v<MODEL, ROBUST, 1>(in, M, out, stream);
  }
  return cudaGetLastError();
}

template <int MODEL>
cudaError_t launch_robust(int robust, const void* const* in, int M, int vec_mode,
                          void* const* out, cudaStream_t stream) {
  switch (robust) {
    case ROBUST_GAUSSIAN: return launch<MODEL, ROBUST_GAUSSIAN>(in, M, vec_mode, out, stream);
    case ROBUST_HUBER:    return launch<MODEL, ROBUST_HUBER>(in, M, vec_mode, out, stream);
    case ROBUST_CAUCHY:   return launch<MODEL, ROBUST_CAUCHY>(in, M, vec_mode, out, stream);
    default:              return cudaErrorInvalidValue;
  }
}

}  // namespace pysfm

extern "C" cudaError_t pysfm_proj_cm(int model, int robust,
                                     const void* R, const void* t, const void* intr,
                                     const void* X, const void* obs_cam,
                                     const void* obs_pt, const void* uv, const void* w,
                                     const void* fixed, const void* scale, int M,
                                     int vec_mode, void* rt, void* Jct, void* Jpt, void* wt,
                                     void* stream) {
  using namespace pysfm;
  if (M <= 0 || vec_mode < -1 || vec_mode > 1) return cudaErrorInvalidValue;
  const void* in[10] = {R, t, intr, X, obs_cam, obs_pt, uv, w, fixed, scale};
  void* out[4] = {rt, Jct, Jpt, wt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case MODEL_POSE:   return launch_robust<MODEL_POSE>(robust, in, M, vec_mode, out, s);
    case MODEL_POSE_K: return launch_robust<MODEL_POSE_K>(robust, in, M, vec_mode, out, s);
    case MODEL_BAL:    return launch_robust<MODEL_BAL>(robust, in, M, vec_mode, out, s);
    default:           return cudaErrorInvalidValue;
  }
}
