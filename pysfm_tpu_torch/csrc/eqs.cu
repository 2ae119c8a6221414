// Normal-equation build (K_E), coupling rows alone (K_D) and robust cost
// (K_C) of the pcg route.
//
// Replaces the Pallas TPU kernels of pysfm_tpu/solver/kernels/pallas_spmv.py
// build_eqs_grouped (K_E, _ke_kernel, :843 / :929), payload_b_grouped (K_D,
// _kd_kernel, :703 / :762) and cost_grouped (K_C, _kc_kernel, :1091 /
// :1149).  Inputs are the CMProblem's own arrays, observations sorted by
// point, and the static layout of spmv.py's GroupedOps:
//   ctab [Dc, C]  packed camera table (problem/cm.py: cam_table)
//   X3 [3, P]     points, component-major
//   obs_cam, obs_pt, u, v, w [M]
//   pt_ptr [P+1], tile_pt  each point's observations; point-aligned tiles
//   cam_perm [M]  observation ids stably sorted by camera, and in that
//                 order cam_pt, u_cam, v_cam, w_cam [M] (obs_pt[cam_perm],
//                 ...); chunk_off / chunk_ptr  chunks of at most 1024
//                 camera-sorted observations inside one camera
//
// K_E writes, for the linearization at the current parameters,
//   b_rows [3*CP, M]  row k*CP + d = w (Jc0d Jp0k + Jc1d Jp1k), f32 or bf16,
//                     point-sorted (read by hcpT_x)
//   b_cam [3*CP, M]   the same rows camera-sorted, b_cam[:, j] =
//                     b_rows[:, cam_perm[j]] bit for bit (read by hcp_w, K_H)
//   hpp6 [6, P], g_p [3, P]       point blocks (lower triangle) and gradient
//   Hcc [C, CP, CP], g_c [C, CP]  camera blocks (full, symmetric) and gradient
// in two passes that share one device function (linearize, in
// project_jac.cuh) and one row expression (coupling_row), so they see the
// same residuals, Jacobians and weights and store the same row bits:
// - point pass: one block per point-aligned tile (tile_pt, the plan of
//   hcpT_x), one thread per observation.  Thread m stores column m of
//   b_rows, so neighbouring threads store neighbouring columns of every row
//   (coalesced, as in K_D), and parks its 9 point terms in shared memory
//   (36 KB at 1024 observations a tile); one thread per point then adds its
//   range there in order.  A point alone in its tile (a track longer than
//   half a tile) is summed block-wide (block_sum, common.cuh).
// - camera pass: one block per chunk (chunk_off, the plan of hcp_w and
//   K_H), ~200 blocks at the 50-camera headline where one per camera gave
//   50.  Thread j reads cam_pt, u_cam, v_cam, w_cam in order (coalesced),
//   recomputes the projection (cheap next to storing the rows again),
//   stores column j of b_cam (the JAX package's permute_b_rows, :150, done
//   where the rows are computed) and keeps the chunk's tri(CP) + CP camera
//   sums in registers; a block_sum gives the chunk's partials, and
//   camera_combine_kernel (common.cuh) adds each camera's in chunk order.
// K_D writes b_rows alone: one thread per observation (grid-stride), the
// same linearize call and row expression as K_E's passes.  No solve path
// calls it, as in the JAX package.
// K_C: one launch.  One block of 1024 threads per SM at most walks the
// point-sorted observations (grid-stride), two an iteration with every
// load issued first; ids, u, v, w and points are read in order, the camera
// values from ctab (L2-resident); per-block sums in double.  The last
// block to finish, found by an integer ticket, adds the partials in block
// order and writes the result; it also sets the ticket back to 0.
// No float atomics anywhere: every output is the same bit for bit on every
// run.  K_C's ticket is an integer atomicAdd that only decides which block
// adds the partials; the order of the sum is fixed, so its bits are too.
//
// Bound on the H100 SXM (3.35 TB/s): the function (JAX build_eqs_grouped)
// reads ~24 B an observation (ids, u, v, w, the cam_perm entry) and writes
// one copy of the rows, 3*CP*4 B (72 B for the pose model in f32), so it is
// bound by the row stores; the tables ctab and X3 are L2-resident or read
// once.  At the Venice scale (M ~ 5M) that is ~0.53 GB, ~0.16 ms.  This
// port's layout adds, outside the function's bytes, the second copy b_cam
// (3*CP*4*M bytes stored: 360 MB at Venice in f32, 180 MB in bf16; ~0.11
// ms more at the memory rate, reported apart) and the camera pass's 16 B an
// observation of camera-sorted inputs.  The LM loop frees a linearization
// before it builds the next, so one pair of copies is live.  K_D reads 20 B
// an observation and writes one copy of the rows: ~0.46 GB, ~0.14 ms.  K_C
// reads 20 B an observation and the tables once, ~0.034 ms there; its
// former design (blocks of 256 threads, one observation a thread an
// iteration, a second launch for the partials) took 2.2x that.  Both K_E
// passes hold a linearization per thread (the camera pass also its tri(CP)
// + CP sums); registers and spills are in ptxas's report, which
// chip_smoke.py prints, and measured times in PERF.md.
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

// Observation m of point p: linearize, store column m of b_rows (the
// point pass's store, coalesced across a warp), and return the point's 9
// terms, hpp6 (lower triangle 00, 10, 11, 20, 21, 22, as scale.TRI3) then
// g_p.
template <int MODEL, int ROBUST, typename TR>
__device__ __forceinline__ void point_terms(const float* __restrict__ ctab, int C,
                                            const float* __restrict__ X3, int P,
                                            const int32_t* __restrict__ obs_cam,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ w, float sc,
                                            size_t Ms, int m, int p,
                                            TR* __restrict__ b_rows, float (&h)[9]) {
  constexpr int CP = ModelTraits<MODEL>::CP;
  ProjJac<MODEL> o;
  const float wq = linearize<MODEL, ROBUST>(ctab, C, X3, P, __ldg(obs_cam + m), p,
                                            __ldg(u + m), __ldg(v + m), __ldg(w + m), sc, o);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int d = 0; d < CP; ++d) {
      row_store(b_rows + (k * CP + d) * Ms + m, coupling_row(o, wq, k, d));
    }
  }
  const float wr0 = wq * o.r[0];
  const float wr1 = wq * o.r[1];
  h[0] = wq * (o.Jp[0][0] * o.Jp[0][0] + o.Jp[1][0] * o.Jp[1][0]);
  h[1] = wq * (o.Jp[0][1] * o.Jp[0][0] + o.Jp[1][1] * o.Jp[1][0]);
  h[2] = wq * (o.Jp[0][1] * o.Jp[0][1] + o.Jp[1][1] * o.Jp[1][1]);
  h[3] = wq * (o.Jp[0][2] * o.Jp[0][0] + o.Jp[1][2] * o.Jp[1][0]);
  h[4] = wq * (o.Jp[0][2] * o.Jp[0][1] + o.Jp[1][2] * o.Jp[1][1]);
  h[5] = wq * (o.Jp[0][2] * o.Jp[0][2] + o.Jp[1][2] * o.Jp[1][2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) h[6 + k] = o.Jp[0][k] * wr0 + o.Jp[1][k] * wr1;
}

// Point pass: one block per tile of tile_pt, one thread per observation.
// Thread m parks its 9 point terms in shared memory and one thread per
// point then adds its range there in order; a point alone in its tile
// (track longer than half a tile) is a block-wide sum instead.
template <int MODEL, int ROBUST, typename TR>
__global__ void __launch_bounds__(kBlock)
eqs_point_kernel(const float* __restrict__ ctab, int C,
                 const float* __restrict__ X3, int P,
                 const int32_t* __restrict__ obs_cam,
                 const int32_t* __restrict__ obs_pt,
                 const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ w,
                 const int32_t* __restrict__ pt_ptr,    // [P+1]
                 const int32_t* __restrict__ tile_pt,   // [n_tiles+1]
                 int tile_obs,
                 const float* __restrict__ scale, int M,
                 TR* __restrict__ b_rows,          // [3*CP, M]
                 float* __restrict__ hpp6,         // [6, P]
                 float* __restrict__ g_p) {        // [3, P]
  extern __shared__ float q[];                     // [9, tile_obs]
  __shared__ float red[kBlock / 32 * 9];
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  const float sc = __ldg(scale);
  const int t = blockIdx.x;
  const int p0 = __ldg(tile_pt + t);
  const int p1 = __ldg(tile_pt + t + 1);
  const int lo = __ldg(pt_ptr + p0);
  const int hi = __ldg(pt_ptr + p1);
  if (p1 - p0 == 1) {
    float acc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = 0.f;
    for (int m = lo + threadIdx.x; m < hi; m += kBlock) {
      float h[9];
      point_terms<MODEL, ROBUST, TR>(ctab, C, X3, P, obs_cam, u, v, w, sc, Ms, m, p0,
                                     b_rows, h);
#pragma unroll
      for (int i = 0; i < 9; ++i) acc[i] += h[i];
    }
    const float total = block_sum<9>(acc, red);
    if (threadIdx.x < 6) {
      hpp6[threadIdx.x * Ps + p0] = total;
    } else if (threadIdx.x < 9) {
      g_p[(threadIdx.x - 6) * Ps + p0] = total;
    }
    return;
  }
  for (int m = lo + threadIdx.x; m < hi; m += kBlock) {
    float h[9];
    point_terms<MODEL, ROBUST, TR>(ctab, C, X3, P, obs_cam, u, v, w, sc, Ms, m,
                                   __ldg(obs_pt + m), b_rows, h);
#pragma unroll
    for (int i = 0; i < 9; ++i) q[i * tile_obs + (m - lo)] = h[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p1 - p0; i += kBlock) {
    const int a = __ldg(pt_ptr + p0 + i) - lo;
    const int e = __ldg(pt_ptr + p0 + i + 1) - lo;
    float s[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = 0.f;
    for (int j = a; j < e; ++j) {
#pragma unroll
      for (int k = 0; k < 9; ++k) s[k] += q[k * tile_obs + j];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) hpp6[k * Ps + p0 + i] = s[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) g_p[k * Ps + p0 + i] = s[6 + k];
  }
}

// Camera pass: one block per chunk of chunk_off (camera-sorted observations,
// never across a camera).  Thread j reads the camera-sorted cam_pt, u, v, w
// in order, recomputes the projection, stores column j of b_cam, and keeps
// the chunk's tri(CP) + CP camera sums, reduced to partial [NV, n_chunks];
// camera_combine_kernel (common.cuh) adds each camera's in chunk order.
template <int MODEL, int ROBUST, typename TR>
__global__ void __launch_bounds__(kBlock)
eqs_camera_kernel(const float* __restrict__ ctab, int C,
                  const float* __restrict__ X3, int P,
                  const int32_t* __restrict__ obs_cam,
                  const int32_t* __restrict__ cam_perm,
                  const int32_t* __restrict__ cam_pt,
                  const float* __restrict__ u_cam, const float* __restrict__ v_cam,
                  const float* __restrict__ w_cam,
                  const int32_t* __restrict__ chunk_off,  // [n_chunks+1]
                  int n_chunks,
                  const float* __restrict__ scale, int M,
                  TR* __restrict__ b_cam,           // [3*CP, M], camera-sorted
                  float* __restrict__ partial) {    // [tri(CP) + CP, n_chunks]
  constexpr int CP = ModelTraits<MODEL>::CP;
  constexpr int NT = CP * (CP + 1) / 2;
  constexpr int NV = NT + CP;
  __shared__ float smem[kBlock / 32 * NV];
  const int i = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  const float sc = __ldg(scale);
  const int j0 = __ldg(chunk_off + i);
  const int j1 = __ldg(chunk_off + i + 1);
  const int c = __ldg(obs_cam + __ldg(cam_perm + j0));  // the chunk's camera
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  for (int j = j0 + threadIdx.x; j < j1; j += kBlock) {
    ProjJac<MODEL> o;
    const float wq = linearize<MODEL, ROBUST>(
        ctab, C, X3, P, c, __ldg(cam_pt + j), __ldg(u_cam + j), __ldg(v_cam + j),
        __ldg(w_cam + j), sc, o);
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
  if (threadIdx.x < NV) partial[threadIdx.x * static_cast<size_t>(n_chunks) + i] = total;
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

// K_C's block: one block per SM (at most), 1024 threads; each thread
// takes kCostIlp observations an iteration, every load of all of them
// started before any is computed.
constexpr int kCostBlock = 1024;
constexpr int kCostIlp = 2;

// K_C in one launch: a grid-stride loop over the point-sorted
// observations, whose ids, u, v, w and points (X3) are read in order and
// whose camera values are read from ctab (load_cam, as K_E and K_D do),
// kCostIlp of them an iteration with every load started before any is
// computed; observation m0 + q * stride is the q-th of an iteration, so
// each thread adds its terms in the order of a plain grid-stride loop.
// Each block writes its double partial; the last block to finish (an
// integer ticket) adds the partials in block order and writes the f32
// result.
template <int MODEL, int ROBUST>
__global__ void __launch_bounds__(kCostBlock, 1)
cost_kernel(const float* __restrict__ ctab, int C,
            const float* __restrict__ X3, int P,
            const int32_t* __restrict__ obs_cam,
            const int32_t* __restrict__ obs_pt,
            const float* __restrict__ u, const float* __restrict__ v,
            const float* __restrict__ w,
            const float* __restrict__ scale, int M,
            double* __restrict__ partial,        // [gridDim.x]
            unsigned int* __restrict__ ticket,   // 0 before and after
            float* __restrict__ out) {
  __shared__ double red[kCostBlock / 32];
  __shared__ bool last;
  const size_t Ps = static_cast<size_t>(P);
  const float sc = __ldg(scale);
  double acc[1] = {0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCostBlock;
  for (int64_t m0 = static_cast<int64_t>(blockIdx.x) * kCostBlock + threadIdx.x; m0 < M;
       m0 += kCostIlp * stride) {
    int cq[kCostIlp], pq[kCostIlp];
    float uq[kCostIlp], vq[kCostIlp], wq[kCostIlp];
#pragma unroll
    for (int q = 0; q < kCostIlp; ++q) {
      // Past M, observation m0 again (loaded, never added).
      const int64_t m = m0 + q * stride < M ? m0 + q * stride : m0;
      cq[q] = __ldg(obs_cam + m);
      pq[q] = __ldg(obs_pt + m);
      uq[q] = __ldg(u + m);
      vq[q] = __ldg(v + m);
      wq[q] = __ldg(w + m);
    }
    CamParams<MODEL> k[kCostIlp];
    float X[kCostIlp][3];
#pragma unroll
    for (int q = 0; q < kCostIlp; ++q) {
      load_cam<MODEL>(ctab, C, cq[q], k[q]);
#pragma unroll
      for (int i = 0; i < 3; ++i) X[q][i] = __ldg(X3 + i * Ps + pq[q]);
    }
#pragma unroll
    for (int q = 0; q < kCostIlp; ++q) {
      // Only the residual of project_jac is used; the compiler drops the
      // Jacobians of this inlined call.
      ProjJac<MODEL> o;
      project_jac<MODEL>(k[q].R, k[q].t, k[q].intr, X[q], uq[q], vq[q], o);
      const float s = o.r[0] * o.r[0] + o.r[1] * o.r[1];
      if (m0 + q * stride < M) acc[0] += static_cast<double>(wq[q] * robust_rho<ROBUST>(s, sc));
    }
  }
  const double total = block_sum<1, double, kCostBlock>(acc, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double part[1] = {0.0};
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kCostBlock) {
    part[0] += __ldcg(partial + i);  // from L2: other SMs wrote them
  }
  const double sum = block_sum<1, double, kCostBlock>(part, red);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(0.5 * sum);
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

// The observation inputs of K_E, K_D and K_C.
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
  const float* scale;
  int M;
};

// K_E's plans and camera-sorted inputs: the point pass's tiles, the camera
// pass's chunks, and the chunk partials' scratch.
struct EqsPlan {
  const int32_t* pt_ptr;
  const int32_t* tile_pt;
  int n_tiles, tile_obs;
  const int32_t* cam_perm;
  const int32_t* cam_pt;
  const float* u_cam;
  const float* v_cam;
  const float* w_cam;
  const int32_t* chunk_off;
  int n_chunks;
  const int32_t* chunk_ptr;
  float* partial;
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
cudaError_t launch_eqs(const EqsArgs& a, const EqsPlan& pl, const EqsOut& out,
                       cudaStream_t s) {
  constexpr int CP = ModelTraits<MODEL>::CP;
  const size_t q_bytes = sizeof(float) * 9 * static_cast<size_t>(pl.tile_obs);
  eqs_point_kernel<MODEL, ROBUST, TR><<<pl.n_tiles, kBlock, q_bytes, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_cam, a.obs_pt, a.u, a.v, a.w, pl.pt_ptr, pl.tile_pt,
      pl.tile_obs, a.scale, a.M, static_cast<TR*>(out.b_rows), out.hpp6, out.g_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  eqs_camera_kernel<MODEL, ROBUST, TR><<<pl.n_chunks, kBlock, 0, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_cam, pl.cam_perm, pl.cam_pt, pl.u_cam, pl.v_cam,
      pl.w_cam, pl.chunk_off, pl.n_chunks, a.scale, a.M, static_cast<TR*>(out.b_cam),
      pl.partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_camera_combine<CP>(pl.partial, pl.n_chunks, pl.chunk_ptr, a.C,
                                   CP * (CP + 1) / 2 + CP, out.Hcc, out.g_c, s);
}

template <int MODEL, int ROBUST>
cudaError_t launch_eqs_rows(const EqsArgs& a, const EqsPlan& pl, int rows_bf16,
                            const EqsOut& out, cudaStream_t s) {
  return rows_bf16 ? launch_eqs<MODEL, ROBUST, __nv_bfloat16>(a, pl, out, s)
                   : launch_eqs<MODEL, ROBUST, float>(a, pl, out, s);
}

template <int MODEL>
cudaError_t eqs_robust(int robust, const EqsArgs& a, const EqsPlan& pl, int rows_bf16,
                       const EqsOut& out, cudaStream_t s) {
  switch (robust) {
    case ROBUST_GAUSSIAN: return launch_eqs_rows<MODEL, ROBUST_GAUSSIAN>(a, pl, rows_bf16, out, s);
    case ROBUST_HUBER:    return launch_eqs_rows<MODEL, ROBUST_HUBER>(a, pl, rows_bf16, out, s);
    case ROBUST_CAUCHY:   return launch_eqs_rows<MODEL, ROBUST_CAUCHY>(a, pl, rows_bf16, out, s);
    default: return cudaErrorInvalidValue;
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

// K_C's launch: one block per SM at most, and at most n_partial blocks.
template <int MODEL, int ROBUST>
cudaError_t launch_cost(const EqsArgs& a, double* partial, int n_partial,
                        unsigned int* ticket, float* out, cudaStream_t s) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = device_limits(dev, sms, optin);
  if (err != cudaSuccess) return err;
  const int64_t need = (static_cast<int64_t>(a.M) + kCostBlock - 1) / kCostBlock;
  int grid = static_cast<int>(need < sms ? need : sms);
  if (grid > n_partial) grid = n_partial;
  cost_kernel<MODEL, ROBUST><<<grid, kCostBlock, 0, s>>>(
      a.ctab, a.C, a.X3, a.P, a.obs_cam, a.obs_pt, a.u, a.v, a.w, a.scale, a.M, partial,
      ticket, out);
  return cudaGetLastError();
}

template <int MODEL>
cudaError_t cost_robust(int robust, const EqsArgs& a, double* partial, int n_partial,
                        unsigned int* ticket, float* out, cudaStream_t s) {
  switch (robust) {
    case ROBUST_GAUSSIAN: return launch_cost<MODEL, ROBUST_GAUSSIAN>(a, partial, n_partial, ticket, out, s);
    case ROBUST_HUBER:    return launch_cost<MODEL, ROBUST_HUBER>(a, partial, n_partial, ticket, out, s);
    case ROBUST_CAUCHY:   return launch_cost<MODEL, ROBUST_CAUCHY>(a, partial, n_partial, ticket, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pysfm

extern "C" cudaError_t pysfm_build_eqs(
    int model, int robust, int rows_bf16, const void* ctab, int C,
    const void* X3, int P, const void* obs_cam, const void* obs_pt,
    const void* u, const void* v, const void* w, const void* pt_ptr,
    const void* tile_pt, int n_tiles, int tile_obs, const void* cam_perm,
    const void* cam_pt, const void* u_cam, const void* v_cam, const void* w_cam,
    const void* chunk_off, int n_chunks, const void* chunk_ptr, const void* scale,
    int M, void* partial, void* b_rows, void* b_cam, void* Hcc, void* g_c,
    void* hpp6, void* g_p, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_tiles <= 0 || tile_obs <= 0 || n_chunks <= 0) {
    return cudaErrorInvalidValue;
  }
  const EqsArgs a{
      static_cast<const float*>(ctab), C, static_cast<const float*>(X3), P,
      static_cast<const int32_t*>(obs_cam), static_cast<const int32_t*>(obs_pt),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(scale), M};
  const EqsPlan pl{
      static_cast<const int32_t*>(pt_ptr), static_cast<const int32_t*>(tile_pt), n_tiles,
      tile_obs, static_cast<const int32_t*>(cam_perm), static_cast<const int32_t*>(cam_pt),
      static_cast<const float*>(u_cam), static_cast<const float*>(v_cam),
      static_cast<const float*>(w_cam), static_cast<const int32_t*>(chunk_off), n_chunks,
      static_cast<const int32_t*>(chunk_ptr), static_cast<float*>(partial)};
  const EqsOut out{b_rows, b_cam, static_cast<float*>(Hcc), static_cast<float*>(g_c),
                   static_cast<float*>(hpp6), static_cast<float*>(g_p)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case MODEL_POSE:   return eqs_robust<MODEL_POSE>(robust, a, pl, rows_bf16, out, s);
    case MODEL_POSE_K: return eqs_robust<MODEL_POSE_K>(robust, a, pl, rows_bf16, out, s);
    case MODEL_BAL:    return eqs_robust<MODEL_BAL>(robust, a, pl, rows_bf16, out, s);
    default:           return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t pysfm_cost(
    int model, int robust, const void* ctab, int C, const void* X3, int P,
    const void* obs_cam, const void* obs_pt, const void* u, const void* v,
    const void* w, const void* scale, int M, void* partial, int n_partial, void* ticket,
    void* out, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_partial <= 0) {
    return cudaErrorInvalidValue;
  }
  const EqsArgs a{
      static_cast<const float*>(ctab), C, static_cast<const float*>(X3), P,
      static_cast<const int32_t*>(obs_cam), static_cast<const int32_t*>(obs_pt),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(scale), M};
  double* part = static_cast<double*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case MODEL_POSE:   return cost_robust<MODEL_POSE>(robust, a, part, n_partial, tk, o, s);
    case MODEL_POSE_K: return cost_robust<MODEL_POSE_K>(robust, a, part, n_partial, tk, o, s);
    case MODEL_BAL:    return cost_robust<MODEL_BAL>(robust, a, part, n_partial, tk, o, s);
    default:           return cudaErrorInvalidValue;
  }
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
      static_cast<const float*>(w), static_cast<const float*>(scale), M};
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
