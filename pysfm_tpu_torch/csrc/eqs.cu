// Normal-equation build (K_E), coupling rows alone (K_D) and robust cost
// (K_C) of the pcg route.
//
// Replaces the Pallas TPU kernels of pysfm_tpu/solver/kernels/pallas_spmv.py
// build_eqs_grouped (K_E, _ke_kernel, :843 / :929), payload_b_grouped (K_D,
// _kd_kernel, :703 / :762) and cost_grouped (K_C, _kc_kernel, :1091 /
// :1149).  Inputs are the CMProblem's own arrays, observations sorted by
// point:
//   ctab [Dc, C]  packed camera table (problem/cm.py: cam_table)
//   X3 [3, P]     points, component-major
//   obs_cam, obs_pt, u, v, w [M]
//   pt_ptr [P+1]  CSR offsets of each point's observations
//   cam_ptr [C+1], cam_perm [M]  observation ids stably sorted by camera
//
// K_E writes, for the linearization at the current parameters,
//   b_rows [3*CP, M]  row k*CP + d = w (Jc0d Jp0k + Jc1d Jp1k), f32 or bf16,
//                     point-sorted (read by hcpT_x and K_H)
//   b_cam [3*CP, M]   the same rows camera-sorted, b_cam[:, j] =
//                     b_rows[:, cam_perm[j]] bit for bit (read by hcp_w)
//   hpp6 [6, P], g_p [3, P]       point blocks (lower triangle) and gradient
//   Hcc [C, CP, CP], g_c [C, CP]  camera blocks (full, symmetric) and gradient
// in two passes that share one device function (linearize, in
// project_jac.cuh) and one row expression (coupling_row), so they see the
// same residuals, Jacobians and weights and store the same row bits:
// - point pass: one thread per point walks its CSR range in order, writes
//   the b_rows columns and keeps the 6 + 3 point sums in registers;
// - camera pass: one block per camera walks cam_perm, recomputes the
//   projection (cheap next to storing the rows again), stores column j of
//   b_cam (the JAX package's permute_b_rows, :150, done where the rows are
//   computed) and reduces the tri(CP) + CP camera sums with block_sum
//   (common.cuh).
// K_D writes b_rows alone: one thread per observation (grid-stride), the
// same linearize call and row expression as K_E's point pass, so neighbouring
// threads store neighbouring columns of every row (coalesced, unlike K_E's
// point pass).  No solve path calls it, as in the JAX package.
// K_C: one thread per observation (grid-stride), per-block partial sums in
// double, then one block adds the partials in a fixed order.
// No atomics anywhere: every output is the same bit for bit on every run.
//
// Bound on the H100 SXM (3.35 TB/s): the function (JAX build_eqs_grouped)
// reads ~24 B an observation (ids, u, v, w, the cam_perm entry) and writes
// one copy of the rows, 3*CP*4 B (72 B for the pose model in f32), so it is
// bound by the row stores; the tables ctab and X3 are L2-resident or read
// once.  At the Venice scale (M ~ 5M) that is ~0.53 GB, ~0.16 ms.  The
// second copy, b_cam, is this port's layout for hcp_w, not part of the
// function: it costs 3*CP*4*M more bytes stored (360 MB at Venice in f32,
// 180 MB in bf16; ~0.11 ms more at the memory rate), reported apart.  The
// LM loop frees a linearization before it builds the next, so one pair of
// copies is live.  K_D reads 20 B an
// observation and writes one copy of the rows: ~0.46 GB, ~0.14 ms.  K_C
// reads ~24 B an observation, ~0.04 ms there.  The point pass writes b_rows
// strided by the track length within a warp (threads own neighbouring
// points), so its stores coalesce only partly; the camera pass reads u, v,
// w, obs_pt through cam_perm, scattered, and stores b_cam coalesced.  Both
// passes are the first design; measured times are in PERF.md.
//
// C entries, called through ctypes: they launch on the given stream,
// allocate nothing, do not synchronize, and return cudaGetLastError().
#include "common.cuh"
#include "project_jac.cuh"

namespace pysfm {

// Coupling row k*CP + d of one observation, w (Jc0d Jp0k + Jc1d Jp1k): the
// one expression of every kernel that stores rows, so their rows agree bit
// for bit.
template <int MODEL>
__device__ __forceinline__ float coupling_row(const ProjJac<MODEL>& o, float wq, int k,
                                              int d) {
  return wq * (o.Jc[0][d] * o.Jp[0][k] + o.Jc[1][d] * o.Jp[1][k]);
}

template <int MODEL, int ROBUST, typename TR>
__global__ void __launch_bounds__(kBlock)
eqs_point_kernel(const float* __restrict__ ctab, int C,
                 const float* __restrict__ X3, int P,
                 const int32_t* __restrict__ obs_cam,
                 const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ w,
                 const int32_t* __restrict__ pt_ptr,
                 const float* __restrict__ scale, int M,
                 TR* __restrict__ b_rows,          // [3*CP, M]
                 float* __restrict__ hpp6,         // [6, P]
                 float* __restrict__ g_p) {        // [3, P]
  constexpr int CP = ModelTraits<MODEL>::CP;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= P) return;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  const float sc = __ldg(scale);
  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float g[3] = {0.f, 0.f, 0.f};
  const int m1 = __ldg(pt_ptr + p + 1);
  for (int m = __ldg(pt_ptr + p); m < m1; ++m) {
    ProjJac<MODEL> o;
    const float wq = linearize<MODEL, ROBUST>(
        ctab, C, X3, P, __ldg(obs_cam + m), p, __ldg(u + m), __ldg(v + m),
        __ldg(w + m), sc, o);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 0; d < CP; ++d) {
        row_store(b_rows + (k * CP + d) * Ms + m, coupling_row(o, wq, k, d));
      }
    }
    const float wr0 = wq * o.r[0];
    const float wr1 = wq * o.r[1];
    // Lower triangle (00, 10, 11, 20, 21, 22), as scale.TRI3.
    h[0] += wq * (o.Jp[0][0] * o.Jp[0][0] + o.Jp[1][0] * o.Jp[1][0]);
    h[1] += wq * (o.Jp[0][1] * o.Jp[0][0] + o.Jp[1][1] * o.Jp[1][0]);
    h[2] += wq * (o.Jp[0][1] * o.Jp[0][1] + o.Jp[1][1] * o.Jp[1][1]);
    h[3] += wq * (o.Jp[0][2] * o.Jp[0][0] + o.Jp[1][2] * o.Jp[1][0]);
    h[4] += wq * (o.Jp[0][2] * o.Jp[0][1] + o.Jp[1][2] * o.Jp[1][1]);
    h[5] += wq * (o.Jp[0][2] * o.Jp[0][2] + o.Jp[1][2] * o.Jp[1][2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] += o.Jp[0][k] * wr0 + o.Jp[1][k] * wr1;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) hpp6[i * Ps + p] = h[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) g_p[k * Ps + p] = g[k];
}

template <int MODEL, int ROBUST, typename TR>
__global__ void __launch_bounds__(kBlock)
eqs_camera_kernel(const float* __restrict__ ctab, int C,
                  const float* __restrict__ X3, int P,
                  const int32_t* __restrict__ obs_pt,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ w,
                  const int32_t* __restrict__ cam_ptr,
                  const int32_t* __restrict__ cam_perm,
                  const float* __restrict__ scale, int M,
                  TR* __restrict__ b_cam,           // [3*CP, M], camera-sorted
                  float* __restrict__ Hcc,          // [C, CP, CP]
                  float* __restrict__ g_c) {        // [C, CP]
  constexpr int CP = ModelTraits<MODEL>::CP;
  constexpr int NT = CP * (CP + 1) / 2;
  constexpr int NV = NT + CP;
  __shared__ float smem[kBlock / 32 * NV];
  const int c = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  const float sc = __ldg(scale);
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  const int j1 = __ldg(cam_ptr + c + 1);
  for (int j = __ldg(cam_ptr + c) + threadIdx.x; j < j1; j += kBlock) {
    const int m = __ldg(cam_perm + j);
    ProjJac<MODEL> o;
    const float wq = linearize<MODEL, ROBUST>(
        ctab, C, X3, P, c, __ldg(obs_pt + m), __ldg(u + m), __ldg(v + m),
        __ldg(w + m), sc, o);
    // Column j of the camera-sorted copy: neighbouring threads store
    // neighbouring columns.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 0; d < CP; ++d) {
        row_store(b_cam + (k * CP + d) * Ms + j, coupling_row(o, wq, k, d));
      }
    }
    const float wr0 = wq * o.r[0];
    const float wr1 = wq * o.r[1];
#pragma unroll
    for (int d = 0; d < CP; ++d) {
#pragma unroll
      for (int e = 0; e <= d; ++e) {
        acc[d * (d + 1) / 2 + e] +=
            wq * (o.Jc[0][d] * o.Jc[0][e] + o.Jc[1][d] * o.Jc[1][e]);
      }
      acc[NT + d] += o.Jc[0][d] * wr0 + o.Jc[1][d] * wr1;
    }
  }
  const float total = block_sum<NV>(acc, smem);
  const size_t cs = static_cast<size_t>(c);
  if (threadIdx.x < NT) {
    int d, e;
    tri_index(threadIdx.x, d, e);
    Hcc[(cs * CP + d) * CP + e] = total;
    Hcc[(cs * CP + e) * CP + d] = total;
  } else if (threadIdx.x < NV) {
    g_c[cs * CP + (threadIdx.x - NT)] = total;
  }
}

template <int MODEL, int ROBUST, typename TR>
__global__ void __launch_bounds__(kBlock)
payload_b_kernel(const float* __restrict__ ctab, int C,
                 const float* __restrict__ X3, int P,
                 const int32_t* __restrict__ obs_cam,
                 const int32_t* __restrict__ obs_pt,
                 const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ w,
                 const float* __restrict__ scale, int M,
                 TR* __restrict__ b_rows) {        // [3*CP, M]
  constexpr int CP = ModelTraits<MODEL>::CP;
  const size_t Ms = static_cast<size_t>(M);
  const float sc = __ldg(scale);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  for (int64_t m = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x; m < M;
       m += stride) {
    ProjJac<MODEL> o;
    const float wq = linearize<MODEL, ROBUST>(
        ctab, C, X3, P, __ldg(obs_cam + m), __ldg(obs_pt + m), __ldg(u + m),
        __ldg(v + m), __ldg(w + m), sc, o);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 0; d < CP; ++d) {
        row_store(b_rows + (k * CP + d) * Ms + m, coupling_row(o, wq, k, d));
      }
    }
  }
}

template <int MODEL, int ROBUST>
__global__ void __launch_bounds__(kBlock)
cost_partial_kernel(const float* __restrict__ ctab, int C,
                    const float* __restrict__ X3, int P,
                    const int32_t* __restrict__ obs_cam,
                    const int32_t* __restrict__ obs_pt,
                    const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ w,
                    const float* __restrict__ scale, int M,
                    double* __restrict__ partial) {   // [gridDim.x]
  __shared__ double smem[kBlock / 32];
  const size_t Ps = static_cast<size_t>(P);
  const float sc = __ldg(scale);
  double acc[1] = {0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  for (int64_t m = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x; m < M;
       m += stride) {
    CamParams<MODEL> k;
    load_cam<MODEL>(ctab, C, __ldg(obs_cam + m), k);
    const int p = __ldg(obs_pt + m);
    const float X[3] = {__ldg(X3 + p), __ldg(X3 + Ps + p), __ldg(X3 + 2 * Ps + p)};
    // Only the residual of project_jac is used; the compiler drops the
    // Jacobians of this inlined call.
    ProjJac<MODEL> o;
    project_jac<MODEL>(k.R, k.t, k.intr, X, __ldg(u + m), __ldg(v + m), o);
    const float s = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    acc[0] += static_cast<double>(__ldg(w + m) * robust_rho<ROBUST>(s, sc));
  }
  const double total = block_sum<1>(acc, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kBlock)
cost_final_kernel(const double* __restrict__ partial, int n,
                  float* __restrict__ out) {
  __shared__ double smem[kBlock / 32];
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < n; i += kBlock) acc[0] += partial[i];
  const double total = block_sum<1>(acc, smem);
  if (threadIdx.x == 0) out[0] = static_cast<float>(0.5 * total);
}

struct EqsArgs {
  const float* ctab;
  int C;
  const float* X3;
  int P;
  const int32_t* obs_cam;
  const int32_t* obs_pt;
  const float* u;
  const float* v;
  const float* w;
  const int32_t* pt_ptr;
  const int32_t* cam_ptr;
  const int32_t* cam_perm;
  const float* scale;
  int M;
};

// K_E's outputs: the rows in both orders, then the camera and point sums.
struct EqsOut {
  void* b_rows;
  void* b_cam;
  float* Hcc;
  float* g_c;
  float* hpp6;
  float* g_p;
};

template <int MODEL, int ROBUST, typename TR>
void launch_eqs(const EqsArgs& a, const EqsOut& out, cudaStream_t s) {
  const int pblocks = (a.P + kBlock - 1) / kBlock;
  eqs_point_kernel<MODEL, ROBUST, TR><<<pblocks, kBlock, 0, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_cam, a.u, a.v, a.w, a.pt_ptr, a.scale,
      a.M, static_cast<TR*>(out.b_rows), out.hpp6, out.g_p);
  eqs_camera_kernel<MODEL, ROBUST, TR><<<a.C, kBlock, 0, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_pt, a.u, a.v, a.w, a.cam_ptr, a.cam_perm,
      a.scale, a.M, static_cast<TR*>(out.b_cam), out.Hcc, out.g_c);
}

template <int MODEL, int ROBUST>
void launch_eqs_rows(const EqsArgs& a, int rows_bf16, const EqsOut& out, cudaStream_t s) {
  if (rows_bf16) {
    launch_eqs<MODEL, ROBUST, __nv_bfloat16>(a, out, s);
  } else {
    launch_eqs<MODEL, ROBUST, float>(a, out, s);
  }
}

template <int MODEL>
bool eqs_robust(int robust, const EqsArgs& a, int rows_bf16, const EqsOut& out,
                cudaStream_t s) {
  switch (robust) {
    case ROBUST_GAUSSIAN: launch_eqs_rows<MODEL, ROBUST_GAUSSIAN>(a, rows_bf16, out, s); return true;
    case ROBUST_HUBER:    launch_eqs_rows<MODEL, ROBUST_HUBER>(a, rows_bf16, out, s); return true;
    case ROBUST_CAUCHY:   launch_eqs_rows<MODEL, ROBUST_CAUCHY>(a, rows_bf16, out, s); return true;
    default: return false;
  }
}

// Blocks of K_D's grid-stride loop: 16 resident blocks on each of the
// H100's 132 SMs, more than enough to keep the row stores in flight.
constexpr int kPayloadMaxBlocks = 132 * 16;

template <int MODEL, int ROBUST>
void launch_payload(const EqsArgs& a, int rows_bf16, void* b_rows, cudaStream_t s) {
  const int64_t need = (static_cast<int64_t>(a.M) + kBlock - 1) / kBlock;
  const int blocks = static_cast<int>(need < kPayloadMaxBlocks ? need : kPayloadMaxBlocks);
  if (rows_bf16) {
    payload_b_kernel<MODEL, ROBUST, __nv_bfloat16><<<blocks, kBlock, 0, s>>>(
        a.ctab, a.C, a.X3, a.P, a.obs_cam, a.obs_pt, a.u, a.v, a.w, a.scale, a.M,
        static_cast<__nv_bfloat16*>(b_rows));
  } else {
    payload_b_kernel<MODEL, ROBUST, float><<<blocks, kBlock, 0, s>>>(
        a.ctab, a.C, a.X3, a.P, a.obs_cam, a.obs_pt, a.u, a.v, a.w, a.scale, a.M,
        static_cast<float*>(b_rows));
  }
}

template <int MODEL>
bool payload_robust(int robust, const EqsArgs& a, int rows_bf16, void* b_rows,
                    cudaStream_t s) {
  switch (robust) {
    case ROBUST_GAUSSIAN: launch_payload<MODEL, ROBUST_GAUSSIAN>(a, rows_bf16, b_rows, s); return true;
    case ROBUST_HUBER:    launch_payload<MODEL, ROBUST_HUBER>(a, rows_bf16, b_rows, s); return true;
    case ROBUST_CAUCHY:   launch_payload<MODEL, ROBUST_CAUCHY>(a, rows_bf16, b_rows, s); return true;
    default: return false;
  }
}

template <int MODEL, int ROBUST>
void launch_cost(const EqsArgs& a, double* partial, int n_blocks, float* out,
                 cudaStream_t s) {
  cost_partial_kernel<MODEL, ROBUST><<<n_blocks, kBlock, 0, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_cam, a.obs_pt, a.u, a.v, a.w, a.scale, a.M,
      partial);
  cost_final_kernel<<<1, kBlock, 0, s>>>(partial, n_blocks, out);
}

template <int MODEL>
bool cost_robust(int robust, const EqsArgs& a, double* partial, int n_blocks,
                 float* out, cudaStream_t s) {
  switch (robust) {
    case ROBUST_GAUSSIAN: launch_cost<MODEL, ROBUST_GAUSSIAN>(a, partial, n_blocks, out, s); return true;
    case ROBUST_HUBER:    launch_cost<MODEL, ROBUST_HUBER>(a, partial, n_blocks, out, s); return true;
    case ROBUST_CAUCHY:   launch_cost<MODEL, ROBUST_CAUCHY>(a, partial, n_blocks, out, s); return true;
    default: return false;
  }
}

}  // namespace pysfm

extern "C" cudaError_t pysfm_build_eqs(
    int model, int robust, int rows_bf16, const void* ctab, int C,
    const void* X3, int P, const void* obs_cam, const void* obs_pt,
    const void* u, const void* v, const void* w, const void* pt_ptr,
    const void* cam_ptr, const void* cam_perm, const void* scale, int M,
    void* b_rows, void* b_cam, void* Hcc, void* g_c, void* hpp6, void* g_p,
    void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0) return cudaErrorInvalidValue;
  const EqsArgs a{
      static_cast<const float*>(ctab), C, static_cast<const float*>(X3), P,
      static_cast<const int32_t*>(obs_cam), static_cast<const int32_t*>(obs_pt),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const int32_t*>(pt_ptr),
      static_cast<const int32_t*>(cam_ptr), static_cast<const int32_t*>(cam_perm),
      static_cast<const float*>(scale), M};
  const EqsOut out{b_rows, b_cam, static_cast<float*>(Hcc), static_cast<float*>(g_c),
                   static_cast<float*>(hpp6), static_cast<float*>(g_p)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (model) {
    case MODEL_POSE:   ok = eqs_robust<MODEL_POSE>(robust, a, rows_bf16, out, s); break;
    case MODEL_POSE_K: ok = eqs_robust<MODEL_POSE_K>(robust, a, rows_bf16, out, s); break;
    case MODEL_BAL:    ok = eqs_robust<MODEL_BAL>(robust, a, rows_bf16, out, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" cudaError_t pysfm_cost(
    int model, int robust, const void* ctab, int C, const void* X3, int P,
    const void* obs_cam, const void* obs_pt, const void* u, const void* v,
    const void* w, const void* scale, int M, void* partial, int n_blocks,
    void* out, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_blocks <= 0) return cudaErrorInvalidValue;
  const EqsArgs a{
      static_cast<const float*>(ctab), C, static_cast<const float*>(X3), P,
      static_cast<const int32_t*>(obs_cam), static_cast<const int32_t*>(obs_pt),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), nullptr, nullptr, nullptr,
      static_cast<const float*>(scale), M};
  double* part = static_cast<double*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (model) {
    case MODEL_POSE:   ok = cost_robust<MODEL_POSE>(robust, a, part, n_blocks, o, s); break;
    case MODEL_POSE_K: ok = cost_robust<MODEL_POSE_K>(robust, a, part, n_blocks, o, s); break;
    case MODEL_BAL:    ok = cost_robust<MODEL_BAL>(robust, a, part, n_blocks, o, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" cudaError_t pysfm_payload_b(
    int model, int robust, int rows_bf16, const void* ctab, int C,
    const void* X3, int P, const void* obs_cam, const void* obs_pt,
    const void* u, const void* v, const void* w, const void* scale, int M,
    void* b_rows, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0) return cudaErrorInvalidValue;
  const EqsArgs a{
      static_cast<const float*>(ctab), C, static_cast<const float*>(X3), P,
      static_cast<const int32_t*>(obs_cam), static_cast<const int32_t*>(obs_pt),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), nullptr, nullptr, nullptr,
      static_cast<const float*>(scale), M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (model) {
    case MODEL_POSE:   ok = payload_robust<MODEL_POSE>(robust, a, rows_bf16, b_rows, s); break;
    case MODEL_POSE_K: ok = payload_robust<MODEL_POSE_K>(robust, a, rows_bf16, b_rows, s); break;
    case MODEL_BAL:    ok = payload_robust<MODEL_BAL>(robust, a, rows_bf16, b_rows, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
