// An empty kernel: the card's floor for one launch.  chip_smoke.py replays
// it from a CUDA graph beside the smallest kernels (dual_norm, sgl_prox), so
// their times can be read against what any launch costs.  Replaces no TPU
// kernel and runs on no path.
#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int noop_launch(int grid, int block, void* stream) {
  noop_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* noop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
