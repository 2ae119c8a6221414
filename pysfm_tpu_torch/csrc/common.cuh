// Helpers shared by the pcg route's kernels (eqs.cu, spmv.cu): the storage
// type of the coupling rows, a deterministic block-wide sum, the
// fixed-order second pass of the per-chunk camera sums, and the device
// limits behind a persistent grid.
#pragma once

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pysfm {

// Threads per block of every pcg-route kernel.
constexpr int kBlock = 256;

// Coupling rows b_rows [3*CP, M] are stored as f32 or bf16; all arithmetic
// is f32.  The bf16 store rounds to nearest even, as torch's .to(bfloat16)
// and JAX's astype(bfloat16) do.
__device__ __forceinline__ float row_load(const float* p) { return *p; }
__device__ __forceinline__ float row_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// The same loads with the streaming hint (ld.global.cs, evict first), for
// rows that a kernel reads once, so that the vectors it gathers stay in L2.
__device__ __forceinline__ float row_load_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float row_load_stream(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void row_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void row_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Block-wide sum of NV per-thread values, in a fixed order: every warp
// reduces by shuffles, lane 0 parks the warp's NV sums in shared memory,
// and thread i < NV adds the warps' sums of value i in warp order.  No
// atomics, so the result is the same bit for bit on every run.  Returns
// the block total of value threadIdx.x to threads threadIdx.x < NV (0
// elsewhere).  Every thread of the block (BLOCK threads) calls it once;
// smem holds BLOCK / 32 * NV values.
template <int NV, typename T, int BLOCK = kBlock>
__device__ __forceinline__ T block_sum(const T (&acc)[NV], T* smem) {
  constexpr int kWarps = BLOCK / 32;
  static_assert(NV <= BLOCK, "more values than threads");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) smem[warp * NV + i] = v;
  }
  __syncthreads();
  T total = T(0);
  if (threadIdx.x < NV) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += smem[w * NV + threadIdx.x];
  }
  return total;
}

// (d, e), e <= d, of entry i of a packed lower triangle listed row by row:
// (0,0), (1,0), (1,1), (2,0), ... (the order of scale._tri_pairs).
__device__ __forceinline__ void tri_index(int i, int& d, int& e) {
  d = 0;
  while (i > d) {
    i -= d + 1;
    ++d;
  }
  e = i;
}

// The sum of camera c's chunk partials in one row of partial [.., n_chunks],
// in chunk order (chunk_ptr [C+1]: camera c owns chunks chunk_ptr[c] ..
// chunk_ptr[c+1]); 0 for a camera without observations.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ row,
                                           const int32_t* __restrict__ chunk_ptr, int c) {
  float s = 0.f;
  const int i1 = __ldg(chunk_ptr + c + 1);
  for (int i = __ldg(chunk_ptr + c); i < i1; ++i) s += row[i];
  return s;
}

// Second pass of the per-chunk camera sums (K_H, K_E's camera pass): row r
// of partial [n_rows, n_chunks] is entry r of a packed lower triangle
// (r < tri(CP)), written to both halves of S [C, CP, CP], or entry r -
// tri(CP) of g [C, CP].  One thread per (row, camera).
template <int CP>
__global__ void __launch_bounds__(kBlock)
camera_combine_kernel(const float* __restrict__ partial, int n_chunks,
                      const int32_t* __restrict__ chunk_ptr, int C, int n_rows,
                      float* __restrict__ S, float* __restrict__ g) {
  constexpr int NT = CP * (CP + 1) / 2;
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  if (idx >= n_rows * C) return;
  const int r = idx / C;
  const int c = idx - r * C;
  const float s = chunk_sum(partial + r * static_cast<size_t>(n_chunks), chunk_ptr, c);
  const size_t cs = static_cast<size_t>(c);
  if (r < NT) {
    int d, e;
    tri_index(r, d, e);
    S[(cs * CP + d) * CP + e] = s;
    S[(cs * CP + e) * CP + d] = s;
  } else {
    g[cs * CP + (r - NT)] = s;
  }
}

template <int CP>
cudaError_t launch_camera_combine(const float* partial, int n_chunks, const int32_t* chunk_ptr,
                                  int C, int n_rows, float* S, float* g, cudaStream_t s) {
  const int64_t n = static_cast<int64_t>(n_rows) * C;
  camera_combine_kernel<CP><<<static_cast<int>((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      partial, n_chunks, chunk_ptr, C, n_rows, S, g);
  return cudaGetLastError();
}

// The device's SM count and opt-in shared memory per block, read once per
// device: the CG loop launches its kernels once per iteration, from the
// host.
inline cudaError_t device_limits(int dev, int& sms, int& optin) {
  static std::mutex mu;
  static std::map<int, std::pair<int, int>> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    int s = 0, o = 0;
    cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    it = cache.emplace(dev, std::make_pair(s, o)).first;
  }
  sms = it->second.first;
  optin = it->second.second;
  return cudaSuccess;
}

}  // namespace pysfm
