// What the static launch audit asks of a built kernel on the card
// (repro_torch.analysis.launch_audit, code CU007): its attributes, and how
// many blocks of a launch one SM holds.  Each source exports both for its
// instances as <source>_func_attributes and <source>_max_active_blocks (the
// BCD kernels answer the second for whole clusters, bcd_chunk.cuh).
#pragma once
#include <cuda_runtime.h>

// out[0..4]: registers per thread, static shared memory, the most threads a
// block may have, the dynamic shared-memory limit as set now, local memory
// per thread (repro_torch.kernels._util._ATTRIBUTES has the order).
template <typename Kernel>
int write_func_attributes(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The state an occupancy query needs set on a kernel, for the length of the
// query: its dynamic shared-memory limit raised to `smem` where it is lower
// and, for clusters of more than 8 CTAs, the non-portable cluster size
// allowed.  The destructor puts back what was set before, so a query leaves
// the kernel as it found it: a launcher that forgets its own opt-in still
// fails at its launch, whatever was queried before.
template <typename Kernel>
class ScopedQueryAttributes {
 public:
  ScopedQueryAttributes(Kernel kernel, int smem, int cluster = 1)
      : kernel_(kernel) {
    err_ = cudaFuncGetAttributes(&before_, kernel);
    if (err_ == cudaSuccess && smem > before_.maxDynamicSharedSizeBytes) {
      err_ = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      smem_raised_ = err_ == cudaSuccess;
    }
    if (err_ == cudaSuccess && cluster > 8 &&
        !before_.nonPortableClusterSizeAllowed) {
      err_ = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      cluster_allowed_ = err_ == cudaSuccess;
    }
  }
  ~ScopedQueryAttributes() {
    if (smem_raised_)
      cudaFuncSetAttribute(kernel_,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           before_.maxDynamicSharedSizeBytes);
    if (cluster_allowed_)
      cudaFuncSetAttribute(
          kernel_, cudaFuncAttributeNonPortableClusterSizeAllowed, 0);
  }
  ScopedQueryAttributes(const ScopedQueryAttributes&) = delete;
  ScopedQueryAttributes& operator=(const ScopedQueryAttributes&) = delete;
  cudaError_t error() const { return err_; }

 private:
  Kernel kernel_;
  cudaFuncAttributes before_{};
  cudaError_t err_ = cudaSuccess;
  bool smem_raised_ = false;
  bool cluster_allowed_ = false;
};

// Blocks of `block` threads and `smem` bytes of dynamic shared memory one SM
// holds at once; a negative value is a CUDA error code.  The kernel's
// attributes are as they were before the call.
template <typename Kernel>
int max_active_blocks(Kernel kernel, int block, int smem) {
  ScopedQueryAttributes<Kernel> scope(kernel, smem);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, block, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
