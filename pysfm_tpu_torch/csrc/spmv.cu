// The pcg route's sparse products with the coupling block Hcp, and the
// block-Jacobi preconditioner diagonal.
//
// Replaces the Pallas TPU kernels of pysfm_tpu/solver/kernels/pallas_spmv.py:
//   hcpT_x        <- hcpT_x_grouped (K_A, :300 / :343) and hcpT_x_grouped2
//                    (K_A2, :522 / :569)
//                    u[s, p] = sum_{m of p} sum_d B[s*CP+d, m] x[d, cam(m)]
//   hcp_w         <- hcp_w_grouped (K_B, :407 / :444) and hcp_w_grouped2
//                    (K_B2, :609 / :654)
//                    y[d, c] = sum_{m of c} sum_s B[s*CP+d, m] w3[s, pt(m)]
//   precond_diag  <- precond_diag_grouped (K_H, :1002 / :1046)
//                    D[c] = sum_{m of c} B_m Hinv[pt(m)] B_m^T
// The TPU kernels stream one grouped copy of the rows (permute_b_rows, :150)
// and reduce by point with a segmented scan (_seg_scan, :182), because
// Mosaic's one fast gather is local to an (8, 128) register.  Here K_E
// (eqs.cu) writes the rows twice, once in each order a kernel reads:
//   b_rows [3*CP, M]  point-sorted (the CMProblem's order, the B_cm layout)
//   b_cam  [3*CP, M]  camera-sorted: b_cam[:, j] = b_rows[:, cam_perm[j]]
// so every kernel streams its rows in order, neighbouring threads on
// neighbouring columns of each row (coalesced; a warp reads 128 B of a row
// in f32).  A static plan, built once per problem (spmv.py: grouped_ops),
// cuts each stream into pieces a block can own:
//
// - hcpT_x reads b_rows.  Point-aligned tiles (tile_pt): a tile holds whole
//   points and at most tile_obs observations, or one point alone when its
//   track is longer than half a tile.  Thread m of a tile computes the 3
//   partial sums of observation m, parks them in shared memory, and one
//   thread per point then adds its range there in order (the segmented
//   reduction); a lone point is a block-wide sum over as many rounds as its
//   track needs.  Blocks are persistent (as many as fit on the SMs) and walk
//   the tiles; x [CP, C] is copied into shared memory once per block when it
//   fits beside the tile buffer (41 KB at Venice with CP = 6), else each
//   thread gathers it through L1/L2.  Both are one kernel, chosen by size;
//   the device limits and the occupancy behind the grid are read once, not
//   on every launch.  chip_smoke.py times both branches where x fits.
// - hcp_w reads b_cam, plus cam_pt (each camera-ordered observation's
//   point) and w3 [3, P] gathered from L2.  Chunks of at most 1024
//   observations never cross a camera (chunk_off); one block reduces a
//   chunk to CP partial sums, and a second pass adds each camera's chunk
//   partials in chunk order (chunk_ptr).  That is ~200 blocks at the
//   50-camera headline and ~5k at Venice, where one block per camera gave
//   50 and 1712.
// - precond_diag (K_H) runs on the same chunks of b_cam and cam_pt.  A
//   first pass packs hinv6 [6, P] point-major as hinv_pt [P, 8], so that
//   each observation's Hinv is one 32-byte sector (six scattered sectors
//   from hinv6, 24 MB at Venice, were the kernel's largest traffic).  Each
//   thread keeps the tri(CP) sums of B_m Hinv B_m^T in registers (21, 45,
//   55 for CP 6, 9, 10) while cp.async stages its next column of f32 rows
//   in shared memory (bf16 rows, 2 bytes, are loaded directly); a
//   block_sum gives the chunk's partials [tri(CP), n_chunks], and the
//   second pass (camera_combine_kernel, common.cuh) adds each camera's in
//   chunk order and writes both halves of D.  ~216 f32 operations per 72 B
//   of rows at CP = 6, ~3 a byte, far under the card's ridge: tensor cores
//   do not help, moving fewer bytes does.
// No float atomics: every output is the same bit for bit on every run.
//
// Bound on the H100 SXM (3.35 TB/s): each kernel streams one copy of the
// rows once, 3*CP*4 B an observation in f32 (2 B in bf16), plus 4 B of
// indices (K_H: and D, and hinv6 once); at the Venice scale (M ~ 5M, pose,
// f32) ~0.4 GB, ~0.12 ms.  The rows are loaded with the streaming hint
// (evict first) so that x and w3 stay in L2 (K_H's f32 rows go through
// cp.async instead).  The second copy costs
// K_E one more coalesced store of the rows and the device 3*CP*4*M bytes
// more (360 MB at Venice in f32, 180 MB in bf16).
//
// C entries, called through ctypes: they launch on the given stream,
// allocate nothing, do not synchronize, and return the first CUDA error.
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace pysfm {

// u's three partial sums of observation m.  x is read from shared memory
// (STAGE_X) or gathered from global memory through the read-only path.
template <int CP, typename TR, bool STAGE_X>
__device__ __forceinline__ void obs_partial(const TR* __restrict__ b, size_t Ms, int m,
                                            const float* xsrc, int C,
                                            const int32_t* __restrict__ obs_cam,
                                            float (&q)[3]) {
  const int c = __ldg(obs_cam + m);
  float xv[CP];
#pragma unroll
  for (int d = 0; d < CP; ++d) xv[d] = STAGE_X ? xsrc[d * C + c] : __ldg(xsrc + d * C + c);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float acc = row_load_stream(b + (s * CP) * Ms + m) * xv[0];
#pragma unroll
    for (int d = 1; d < CP; ++d) acc += row_load_stream(b + (s * CP + d) * Ms + m) * xv[d];
    q[s] = acc;
  }
}

template <int CP, typename TR, bool STAGE_X>
__global__ void __launch_bounds__(kBlock)
hcpT_x_kernel(const TR* __restrict__ b,              // b_rows [3*CP, M]
              const float* __restrict__ x,           // [CP, C]
              int C,
              const int32_t* __restrict__ obs_cam,
              const int32_t* __restrict__ pt_ptr,    // [P+1]
              int P,
              const int32_t* __restrict__ tile_pt,   // [n_tiles+1]
              int n_tiles, int tile_obs, int M,
              float* __restrict__ u) {               // [3, P]
  extern __shared__ float dyn[];                     // q [3, tile_obs], then x [CP, C]
  __shared__ float red[kBlock / 32 * 3];
  float* q = dyn;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  const float* xsrc = x;
  if (STAGE_X) {
    float* xs = dyn + 3 * tile_obs;
    for (int i = threadIdx.x; i < CP * C; i += kBlock) xs[i] = __ldg(x + i);
    __syncthreads();
    xsrc = xs;
  }
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = __ldg(tile_pt + t);
    const int p1 = __ldg(tile_pt + t + 1);
    const int lo = __ldg(pt_ptr + p0);
    const int hi = __ldg(pt_ptr + p1);
    if (p1 - p0 == 1) {
      // One point: strided per-thread sums, then a block-wide sum.
      float acc[3] = {0.f, 0.f, 0.f};
      for (int m = lo + threadIdx.x; m < hi; m += kBlock) {
        float qm[3];
        obs_partial<CP, TR, STAGE_X>(b, Ms, m, xsrc, C, obs_cam, qm);
#pragma unroll
        for (int s = 0; s < 3; ++s) acc[s] += qm[s];
      }
      const float total = block_sum<3>(acc, red);
      if (threadIdx.x < 3) u[threadIdx.x * Ps + p0] = total;
    } else {
      // Whole points, hi - lo <= tile_obs: park, then one thread a point.
      for (int m = lo + threadIdx.x; m < hi; m += kBlock) {
        float qm[3];
        obs_partial<CP, TR, STAGE_X>(b, Ms, m, xsrc, C, obs_cam, qm);
#pragma unroll
        for (int s = 0; s < 3; ++s) q[s * tile_obs + (m - lo)] = qm[s];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < p1 - p0; i += kBlock) {
        const int a = __ldg(pt_ptr + p0 + i) - lo;
        const int e = __ldg(pt_ptr + p0 + i + 1) - lo;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
        for (int k = a; k < e; ++k) {
          s0 += q[k];
          s1 += q[tile_obs + k];
          s2 += q[2 * tile_obs + k];
        }
        u[p0 + i] = s0;
        u[Ps + p0 + i] = s1;
        u[2 * Ps + p0 + i] = s2;
      }
    }
    __syncthreads();  // q and red are reused by the block's next tile
  }
}

template <int CP, typename TR>
__global__ void __launch_bounds__(kBlock)
hcp_w_chunk_kernel(const TR* __restrict__ b,               // b_cam [3*CP, M]
                   const float* __restrict__ w3,           // [3, P]
                   int P,
                   const int32_t* __restrict__ cam_pt,     // [M]
                   const int32_t* __restrict__ chunk_off,  // [n_chunks+1]
                   int n_chunks, int M,
                   float* __restrict__ partial) {          // [CP, n_chunks]
  __shared__ float smem[kBlock / 32 * CP];
  const int i = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  const size_t Ps = static_cast<size_t>(P);
  float acc[CP];
#pragma unroll
  for (int d = 0; d < CP; ++d) acc[d] = 0.f;
  const int j1 = __ldg(chunk_off + i + 1);
#pragma unroll 4
  for (int j = __ldg(chunk_off + i) + threadIdx.x; j < j1; j += kBlock) {
    const int p = __ldg(cam_pt + j);
    const float w0 = __ldg(w3 + p), w1 = __ldg(w3 + Ps + p), w2 = __ldg(w3 + 2 * Ps + p);
#pragma unroll
    for (int d = 0; d < CP; ++d) {
      acc[d] += row_load_stream(b + d * Ms + j) * w0 +
                row_load_stream(b + (CP + d) * Ms + j) * w1 +
                row_load_stream(b + (2 * CP + d) * Ms + j) * w2;
    }
  }
  const float total = block_sum<CP>(acc, smem);
  if (threadIdx.x < CP) partial[threadIdx.x * static_cast<size_t>(n_chunks) + i] = total;
}

// y[d, c] = the sum of camera c's chunk partials of row d, in chunk order
// (0 for a camera without observations).
__global__ void __launch_bounds__(kBlock)
hcp_w_combine_kernel(const float* __restrict__ partial,    // [CP, n_chunks]
                     int n_chunks,
                     const int32_t* __restrict__ chunk_ptr,  // [C+1]
                     int C, int cp,
                     float* __restrict__ y) {                // [CP, C]
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  if (idx >= cp * C) return;
  const int d = idx / C;
  const int c = idx - d * C;
  y[idx] = chunk_sum(partial + d * static_cast<size_t>(n_chunks), chunk_ptr, c);
}

// Hinv of every point as [P, 8] (6 entries of the lower triangle, then 2
// pad): one 32-byte sector a point, so that K_H's gather of an
// observation's Hinv touches one sector instead of the six of hinv6 [6, P].
__global__ void __launch_bounds__(kBlock)
pack_hinv_kernel(const float* __restrict__ hinv6, int P, float4* __restrict__ hinv_pt) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= P) return;
  const size_t Ps = static_cast<size_t>(P);
  const size_t ps = static_cast<size_t>(p);
  hinv_pt[2 * ps] = make_float4(__ldg(hinv6 + p), __ldg(hinv6 + Ps + p),
                                __ldg(hinv6 + 2 * Ps + p), __ldg(hinv6 + 3 * Ps + p));
  hinv_pt[2 * ps + 1] = make_float4(__ldg(hinv6 + 4 * Ps + p), __ldg(hinv6 + 5 * Ps + p),
                                    0.f, 0.f);
}

// Asynchronous 4-byte copy global -> shared (cp.async, L1-allocating), its
// group commit, and the wait for all but the newest N groups.  The memory
// clobbers keep the compiler from moving shared-memory reads across them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K_H's shared memory for f32 rows: two stages of 3*CP rows x kBlock
// columns (36, 54 and 60 KB for CP 6, 9, 10).  bf16 rows are 2 bytes, under
// cp.async's 4-byte minimum, and are loaded directly.
template <int CP, typename TR>
__host__ __device__ constexpr size_t precond_stage_bytes() {
  return std::is_same<TR, float>::value ? sizeof(float) * 2 * 3 * CP * kBlock : 0;
}

// K_H's first pass: one block per chunk of camera-sorted observations
// streams b_cam and cam_pt in order, gathers each observation's Hinv from
// hinv_pt (one 32-byte sector, from L2), keeps the tri(CP) sums of
// B_m Hinv B_m^T in registers and reduces them to the chunk's partials.
// f32 rows are staged by cp.async, two stages deep: thread t copies column
// j + kBlock of its rows while it computes column j, and reads back only
// what it copied itself (no block barrier).
template <int CP, typename TR>
__global__ void __launch_bounds__(kBlock)
precond_chunk_kernel(const TR* __restrict__ b,               // b_cam [3*CP, M]
                     const float4* __restrict__ hinv_pt,     // [P, 2] float4
                     const int32_t* __restrict__ cam_pt,     // [M]
                     const int32_t* __restrict__ chunk_off,  // [n_chunks+1]
                     int n_chunks, int M,
                     float* __restrict__ partial) {          // [tri(CP), n_chunks]
  constexpr int NT = CP * (CP + 1) / 2;
  constexpr int NR = 3 * CP;
  constexpr bool kStage = precond_stage_bytes<CP, TR>() > 0;
  extern __shared__ float stage[];                           // [2, NR, kBlock]
  __shared__ float smem[kBlock / 32 * NT];
  const int i = blockIdx.x;
  const size_t Ms = static_cast<size_t>(M);
  float acc[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = 0.f;
  const int j1 = __ldg(chunk_off + i + 1);
  int j = __ldg(chunk_off + i) + threadIdx.x;
  if constexpr (kStage) {
    if (j < j1) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        cp_async4(stage + r * kBlock + threadIdx.x,
                  reinterpret_cast<const float*>(b) + r * Ms + j);
      }
    }
    cp_async_commit();
  }
  for (int k = 0; j < j1; j += kBlock, ++k) {
    const int p = __ldg(cam_pt + j);
    // Hinv = [[ha, hb, hd], [hb, hc, he], [hd, he, hf]] (lower-tri order).
    const float4 h03 = __ldg(hinv_pt + 2 * static_cast<size_t>(p));
    const float4 h45 = __ldg(hinv_pt + 2 * static_cast<size_t>(p) + 1);
    const float ha = h03.x, hb = h03.y, hc = h03.z, hd = h03.w, he = h45.x, hf = h45.y;
    float B[NR];
    if constexpr (kStage) {
      const int jn = j + kBlock;
      if (jn < j1) {
        float* next = stage + ((k + 1) & 1) * NR * kBlock;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          cp_async4(next + r * kBlock + threadIdx.x,
                    reinterpret_cast<const float*>(b) + r * Ms + jn);
        }
      }
      cp_async_commit();
      cp_async_wait<1>();
      const float* cur = stage + (k & 1) * NR * kBlock;
#pragma unroll
      for (int r = 0; r < NR; ++r) B[r] = cur[r * kBlock + threadIdx.x];
    } else {
#pragma unroll
      for (int r = 0; r < NR; ++r) B[r] = row_load_stream(b + r * Ms + j);
    }
    const float* B0 = B;
    const float* B1 = B + CP;
    const float* B2 = B + 2 * CP;
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
  if (threadIdx.x < NT) partial[threadIdx.x * static_cast<size_t>(n_chunks) + i] = total;
}

struct HcptArgs {
  const void* b;
  const float* x;
  int C;
  const int32_t* obs_cam;
  const int32_t* pt_ptr;
  int P;
  const int32_t* tile_pt;
  int n_tiles, tile_obs, M;
  int x_mode;  // 1: x in shared memory, 0: x from global memory, -1: by size
  float* u;
};

// Lets `kernel` take `bytes` of dynamic shared memory on device `dev`
// (needed above 48 KB).  The attribute only grows, and is set once per
// device, kernel and size, not on every launch.
cudaError_t allow_dynamic_smem(int dev, const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[std::make_pair(dev, kernel)];
  if (have < bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    have = bytes;
  }
  return cudaSuccess;
}

// Persistent grid: as many blocks as fit on the card at this shared-memory
// size, at most one per tile.  Its occupancy is read once per (device,
// size).
template <int CP, typename TR, bool STAGE_X>
cudaError_t launch_hcpT_x(const HcptArgs& a, int dev, size_t smem, int sms, cudaStream_t s) {
  auto kernel = hcpT_x_kernel<CP, TR, STAGE_X>;
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> per_sm;    // (device, smem) -> blocks
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_pair(dev, smem);
    auto it = per_sm.find(key);
    if (it == per_sm.end()) {
      cudaError_t err = allow_dynamic_smem(dev, reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return err;
      int n = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlock, smem);
      if (err != cudaSuccess) return err;
      it = per_sm.emplace(key, n > 0 ? n : 1).first;
    }
    resident = it->second * sms;
  }
  const int grid = a.n_tiles < resident ? a.n_tiles : resident;
  kernel<<<grid, kBlock, smem, s>>>(static_cast<const TR*>(a.b), a.x, a.C, a.obs_cam,
                                    a.pt_ptr, a.P, a.tile_pt, a.n_tiles, a.tile_obs,
                                    a.M, a.u);
  return cudaGetLastError();
}

// x in shared memory when the tile buffer, x and the reduction scratch fit
// in one block's opt-in shared memory (x_mode -1); x_mode 1 asks for it
// (cudaErrorInvalidValue when it does not fit), 0 gathers x from global
// memory.
template <int CP, typename TR>
struct HcptX {
  static cudaError_t run(const HcptArgs& a, cudaStream_t s) {
    const int x_mode = a.x_mode;
    int dev = 0, sms = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = device_limits(dev, sms, optin);
    if (err != cudaSuccess) return err;
    const size_t q_bytes = sizeof(float) * 3 * static_cast<size_t>(a.tile_obs);
    const size_t x_bytes = sizeof(float) * CP * static_cast<size_t>(a.C);
    const bool fits = q_bytes + x_bytes + sizeof(float) * (kBlock / 32 * 3) <=
                      static_cast<size_t>(optin);
    if (x_mode == 1 && !fits) return cudaErrorInvalidValue;
    if (x_mode == 1 || (x_mode == -1 && fits)) {
      return launch_hcpT_x<CP, TR, true>(a, dev, q_bytes + x_bytes, sms, s);
    }
    return launch_hcpT_x<CP, TR, false>(a, dev, q_bytes, sms, s);
  }
};

struct HcpwArgs {
  const void* b;
  const float* w3;
  int P;
  const int32_t* cam_pt;
  const int32_t* chunk_off;
  int n_chunks;
  const int32_t* chunk_ptr;
  int C, M;
  float* partial;
  float* y;
};

template <int CP, typename TR>
struct HcpW {
  static cudaError_t run(const HcpwArgs& a, cudaStream_t s) {
    hcp_w_chunk_kernel<CP, TR><<<a.n_chunks, kBlock, 0, s>>>(
        static_cast<const TR*>(a.b), a.w3, a.P, a.cam_pt, a.chunk_off, a.n_chunks,
        a.M, a.partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    hcp_w_combine_kernel<<<(CP * a.C + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        a.partial, a.n_chunks, a.chunk_ptr, a.C, CP, a.y);
    return cudaGetLastError();
  }
};

struct PrecondArgs {
  const void* b;
  const float* hinv6;
  int P;
  float* hinv_pt;
  const int32_t* cam_pt;
  const int32_t* chunk_off;
  int n_chunks;
  const int32_t* chunk_ptr;
  int C, M;
  float* partial;
  float* D;
};

template <int CP, typename TR>
struct PrecondDiag {
  static cudaError_t run(const PrecondArgs& a, cudaStream_t s) {
    auto kernel = precond_chunk_kernel<CP, TR>;
    constexpr size_t smem = precond_stage_bytes<CP, TR>();
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = allow_dynamic_smem(dev, reinterpret_cast<const void*>(kernel), smem);
    }
    if (err != cudaSuccess) return err;
    float4* hinv_pt = reinterpret_cast<float4*>(a.hinv_pt);
    pack_hinv_kernel<<<(a.P + kBlock - 1) / kBlock, kBlock, 0, s>>>(a.hinv6, a.P, hinv_pt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kernel<<<a.n_chunks, kBlock, smem, s>>>(static_cast<const TR*>(a.b), hinv_pt, a.cam_pt,
                                            a.chunk_off, a.n_chunks, a.M, a.partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_camera_combine<CP>(a.partial, a.n_chunks, a.chunk_ptr, a.C,
                                     CP * (CP + 1) / 2, a.D, nullptr, s);
  }
};

// Op<CP, row type>::run for the camera dof and row storage type given.
template <template <int, typename> class Op, typename Args>
cudaError_t dispatch(int cp, int rows_bf16, const Args& a, cudaStream_t s) {
  switch (cp) {
    case 6:
      return rows_bf16 ? Op<6, __nv_bfloat16>::run(a, s) : Op<6, float>::run(a, s);
    case 9:
      return rows_bf16 ? Op<9, __nv_bfloat16>::run(a, s) : Op<9, float>::run(a, s);
    case 10:
      return rows_bf16 ? Op<10, __nv_bfloat16>::run(a, s) : Op<10, float>::run(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pysfm

extern "C" cudaError_t pysfm_hcpT_x(int cp, int rows_bf16, const void* b_rows,
                                    const void* x, int C, const void* obs_cam,
                                    const void* pt_ptr, int P, const void* tile_pt,
                                    int n_tiles, int tile_obs, int M, int x_mode, void* u,
                                    void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_tiles <= 0 || tile_obs <= 0 || x_mode < -1 ||
      x_mode > 1) {
    return cudaErrorInvalidValue;
  }
  const HcptArgs a{b_rows, static_cast<const float*>(x), C,
                   static_cast<const int32_t*>(obs_cam),
                   static_cast<const int32_t*>(pt_ptr), P,
                   static_cast<const int32_t*>(tile_pt), n_tiles, tile_obs, M, x_mode,
                   static_cast<float*>(u)};
  return dispatch<HcptX>(cp, rows_bf16, a, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t pysfm_hcp_w(int cp, int rows_bf16, const void* b_cam,
                                   const void* w3, int P, const void* cam_pt,
                                   const void* chunk_off, int n_chunks,
                                   const void* chunk_ptr, int C, int M,
                                   void* partial, void* y, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  const HcpwArgs a{b_cam, static_cast<const float*>(w3), P,
                   static_cast<const int32_t*>(cam_pt),
                   static_cast<const int32_t*>(chunk_off), n_chunks,
                   static_cast<const int32_t*>(chunk_ptr), C, M,
                   static_cast<float*>(partial), static_cast<float*>(y)};
  return dispatch<HcpW>(cp, rows_bf16, a, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t pysfm_precond_diag(int cp, int rows_bf16, const void* b_cam,
                                          const void* hinv6, int P, void* hinv_pt,
                                          const void* cam_pt, const void* chunk_off,
                                          int n_chunks, const void* chunk_ptr, int C, int M,
                                          void* partial, void* D, void* stream) {
  using namespace pysfm;
  if (M <= 0 || P <= 0 || C <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  const PrecondArgs a{b_cam, static_cast<const float*>(hinv6), P,
                      static_cast<float*>(hinv_pt), static_cast<const int32_t*>(cam_pt),
                      static_cast<const int32_t*>(chunk_off), n_chunks,
                      static_cast<const int32_t*>(chunk_ptr), C, M,
                      static_cast<float*>(partial), static_cast<float*>(D)};
  return dispatch<PrecondDiag>(cp, rows_bf16, a, static_cast<cudaStream_t>(stream));
}
