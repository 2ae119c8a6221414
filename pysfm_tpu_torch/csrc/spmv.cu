// The pcg route's sparse products with the coupling block Hcp, and the
// block-Jacobi preconditioner diagonal.
//
// Replaces the Pallas TPU kernels of pysfm_tpu/solver/kernels/pallas_spmv.py:
//   hcpT_x        <- hcpT_x_grouped (K_A) and hcpT_x_grouped2 (K_A2)
//                    u[s, p] = sum_{m of p} sum_d B[s*CP+d, m] x[d, cam(m)]
//   hcp_w         <- hcp_w_grouped (K_B) and hcp_w_grouped2 (K_B2)
//                    y[d, c] = sum_{m of c} sum_s B[s*CP+d, m] w[s, pt(m)]
//   precond_diag  <- precond_diag_grouped (K_H)
//                    D[c] = sum_{m of c} B_m Hinv[pt(m)] B_m^T
// The TPU kernels need a grouped observation stream because Mosaic's only
// fast gather is local to one (8, 128) register; K_A2/K_B2 exist only to
// spread the TPU's fixed cost per grid step.  On Hopper a thread gathers
// from L2 freely, so the kernels here read the CMProblem's own point-sorted
// order: b_rows [3*CP, M] is the B_cm layout, points own CSR ranges
// (pt_ptr), and cameras own ranges of cam_perm (observation ids stably
// sorted by camera).
//
// - hcpT_x: one thread per point sums its CSR range in order; x [CP, C]
//   (at most 1712 x 10 floats) stays in L2.
// - hcp_w, precond_diag: one block per camera walks its cam_perm range and
//   reduces with block_sum (common.cuh); at the 50-camera headline scene
//   that is 50 blocks on 132 SMs.
// No atomics: every output is the same bit for bit on every run.
//
// Bound on the H100 SXM (3.35 TB/s): all three stream b_rows once, 3*CP*4 B
// an observation in f32 (2 B in bf16), plus ~8 B of indices; at the Venice
// scale (M ~ 5M, pose, f32) ~0.4 GB, ~0.12 ms each.  The camera-major pair
// reads b_rows through cam_perm, one 4-byte element per 32-byte sector, so
// it moves up to 8x the bytes it uses; the point-major hcpT_x reads columns
// a track length apart within a warp.  Both are the simple first design;
// measured times are in PERF.md.
//
// C entries, called through ctypes: they launch on the given stream,
// allocate nothing, do not synchronize, and return cudaGetLastError().
#include "common.cuh"

namespace pysfm {

template <int CP, typename TR>
__global__ void __launch_bounds__(kBlock)
hcpT_x_kernel(const TR* __restrict__ b,          // [3*CP, M]
              const float* __restrict__ x,       // [CP, C]
              int C,
              const int32_t* __restrict__ obs_cam,
              const int32_t* __restrict__ pt_ptr,
              int P, int M,
              float* __restrict__ u) {           // [3, P]
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= P) return;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  float acc[3] = {0.f, 0.f, 0.f};
  const int m1 = __ldg(pt_ptr + p + 1);
  for (int m = __ldg(pt_ptr + p); m < m1; ++m) {
    const int c = __ldg(obs_cam + m);
    float xs[CP];
#pragma unroll
    for (int d = 0; d < CP; ++d) xs[d] = __ldg(x + d * C + c);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float q = row_load(b + (s * CP) * Ms + m) * xs[0];
#pragma unroll
      for (int d = 1; d < CP; ++d) q += row_load(b + (s * CP + d) * Ms + m) * xs[d];
      acc[s] += q;
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) u[s * Ps + p] = acc[s];
}

template <int CP, typename TR>
__global__ void __launch_bounds__(kBlock)
hcp_w_kernel(const TR* __restrict__ b,           // [3*CP, M]
             const float* __restrict__ w3,       // [3, P]
             int P,
             const int32_t* __restrict__ obs_pt,
             const int32_t* __restrict__ cam_ptr,
             const int32_t* __restrict__ cam_perm,
             int C, int M,
             float* __restrict__ y) {            // [CP, C]
  __shared__ float smem[kBlock / 32 * CP];
  const int c = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  float acc[CP];
#pragma unroll
  for (int d = 0; d < CP; ++d) acc[d] = 0.f;
  const int j1 = __ldg(cam_ptr + c + 1);
  for (int j = __ldg(cam_ptr + c) + threadIdx.x; j < j1; j += kBlock) {
    const int m = __ldg(cam_perm + j);
    const int p = __ldg(obs_pt + m);
    const float w0 = __ldg(w3 + p), w1 = __ldg(w3 + Ps + p), w2 = __ldg(w3 + 2 * Ps + p);
#pragma unroll
    for (int d = 0; d < CP; ++d) {
      acc[d] += row_load(b + d * Ms + m) * w0 + row_load(b + (CP + d) * Ms + m) * w1 +
                row_load(b + (2 * CP + d) * Ms + m) * w2;
    }
  }
  const float total = block_sum<CP>(acc, smem);
  if (threadIdx.x < CP) y[threadIdx.x * static_cast<size_t>(C) + c] = total;
}

template <int CP, typename TR>
__global__ void __launch_bounds__(kBlock)
precond_diag_kernel(const TR* __restrict__ b,    // [3*CP, M]
                    const float* __restrict__ hinv6,  // [6, P]
                    int P,
                    const int32_t* __restrict__ obs_pt,
                    const int32_t* __restrict__ cam_ptr,
                    const int32_t* __restrict__ cam_perm,
                    int C, int M,
                    float* __restrict__ D) {     // [C, CP, CP]
  constexpr int NT = CP * (CP + 1) / 2;
  __shared__ float smem[kBlock / 32 * NT];
  const int c = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  float acc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i] = 0.f;
  const int j1 = __ldg(cam_ptr + c + 1);
  for (int j = __ldg(cam_ptr + c) + threadIdx.x; j < j1; j += kBlock) {
    const int m = __ldg(cam_perm + j);
    const int p = __ldg(obs_pt + m);
    // Hinv = [[ha, hb, hd], [hb, hc, he], [hd, he, hf]] (lower-tri order).
    const float ha = __ldg(hinv6 + p), hb = __ldg(hinv6 + Ps + p),
                hc = __ldg(hinv6 + 2 * Ps + p), hd = __ldg(hinv6 + 3 * Ps + p),
                he = __ldg(hinv6 + 4 * Ps + p), hf = __ldg(hinv6 + 5 * Ps + p);
    float B0[CP], B1[CP], B2[CP];
#pragma unroll
    for (int d = 0; d < CP; ++d) {
      B0[d] = row_load(b + d * Ms + m);
      B1[d] = row_load(b + (CP + d) * Ms + m);
      B2[d] = row_load(b + (2 * CP + d) * Ms + m);
    }
#pragma unroll
    for (int d = 0; d < CP; ++d) {
      const float h0 = ha * B0[d] + hb * B1[d] + hd * B2[d];
      const float h1 = hb * B0[d] + hc * B1[d] + he * B2[d];
      const float h2 = hd * B0[d] + he * B1[d] + hf * B2[d];
#pragma unroll
      for (int e = 0; e <= d; ++e) {
        acc[d * (d + 1) / 2 + e] += h0 * B0[e] + h1 * B1[e] + h2 * B2[e];
      }
    }
  }
  const float total = block_sum<NT>(acc, smem);
  if (threadIdx.x < NT) {
    int d, e;
    tri_index(threadIdx.x, d, e);
    const size_t cs = static_cast<size_t>(c);
    D[(cs * CP + d) * CP + e] = total;
    D[(cs * CP + e) * CP + d] = total;
  }
}

struct SpmvArgs {
  const void* b;
  const float* vec;         // x [CP, C], w3 [3, P] or hinv6 [6, P]
  const int32_t* obs_idx;   // obs_cam (hcpT_x) or obs_pt
  const int32_t* ptr;       // pt_ptr (hcpT_x) or cam_ptr
  const int32_t* cam_perm;
  int C, P, M;
  float* out;
};

enum Op : int { OP_HCPT_X = 0, OP_HCP_W = 1, OP_PRECOND_DIAG = 2 };

template <int CP, typename TR>
void launch_op(int op, const SpmvArgs& a, cudaStream_t s) {
  const TR* b = static_cast<const TR*>(a.b);
  switch (op) {
    case OP_HCPT_X:
      hcpT_x_kernel<CP, TR><<<(a.P + kBlock - 1) / kBlock, kBlock, 0, s>>>(
          b, a.vec, a.C, a.obs_idx, a.ptr, a.P, a.M, a.out);
      break;
    case OP_HCP_W:
      hcp_w_kernel<CP, TR><<<a.C, kBlock, 0, s>>>(
          b, a.vec, a.P, a.obs_idx, a.ptr, a.cam_perm, a.C, a.M, a.out);
      break;
    default:
      precond_diag_kernel<CP, TR><<<a.C, kBlock, 0, s>>>(
          b, a.vec, a.P, a.obs_idx, a.ptr, a.cam_perm, a.C, a.M, a.out);
      break;
  }
}

template <int CP>
void launch_rows(int op, int rows_bf16, const SpmvArgs& a, cudaStream_t s) {
  if (rows_bf16) {
    launch_op<CP, __nv_bfloat16>(op, a, s);
  } else {
    launch_op<CP, float>(op, a, s);
  }
}

}  // namespace pysfm

// op: 0 hcpT_x (vec = x [CP, C], obs_idx = obs_cam, ptr = pt_ptr),
//     1 hcp_w (vec = w3 [3, P], obs_idx = obs_pt, ptr = cam_ptr, cam_perm),
//     2 precond_diag (vec = hinv6 [6, P], as hcp_w).
extern "C" cudaError_t pysfm_spmv(int op, int cp, int rows_bf16, const void* b,
                                  const void* vec, const void* obs_idx,
                                  const void* ptr, const void* cam_perm, int C,
                                  int P, int M, void* out, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || op < 0 || op > 2) return cudaErrorInvalidValue;
  const SpmvArgs a{b, static_cast<const float*>(vec),
                   static_cast<const int32_t*>(obs_idx),
                   static_cast<const int32_t*>(ptr),
                   static_cast<const int32_t*>(cam_perm), C, P, M,
                   static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp) {
    case 6:  launch_rows<6>(op, rows_bf16, a, s); break;
    case 9:  launch_rows<9>(op, rows_bf16, a, s); break;
    case 10: launch_rows<10>(op, rows_bf16, a, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
