// An empty kernel: the floor under every kernel time that chip_smoke.py
// reports.  Timed exactly as the kernels are (CUDA events behind a sleep
// kernel), it gives the part of a small kernel's time that no design can
// remove: the launch and the events around it.  Nothing in the port calls
// it.
//
// C entry: pysfm_noop, called through ctypes; it launches one block of 32
// threads on the given stream and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace pysfm {

__global__ void noop_kernel() {}

}  // namespace pysfm

extern "C" cudaError_t pysfm_noop(void* stream) {
  pysfm::noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
