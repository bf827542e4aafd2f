// Correlation matvec corr[b, r] = sum_k Xt[r, k] * theta[b, k] in f64.
//
// Replaces: repro/kernels/screening_scores.py::screening_corr_pallas
// (_corr_kernel), the X^T resid correlation of every certified round, of the
// reduced-gap checks between epoch blocks and, batched over B residuals, of
// the batched-lambda driver.
//
// Bound on this card: bytes.  Each design element is used once per residual,
// so at B = 1 the kernel does 2 flops per 8 bytes read; the (p, n) design
// (479 MB at the climate width p = 73,584, n = 814) streamed once over HBM is
// the floor.  Design: one warp per row of the row-major (p, n) design, the 32
// lanes reading consecutive samples (coalesced 256-byte loads), a shuffle
// reduction over the lanes, and up to kMaxB residuals accumulated per row so
// a batch reads each design row once for all of them.  Rows are masked by the
// warp index, so no padding of p or n is needed (the TPU kernel's (256, 128)
// tiles are not carried over).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 8;

__global__ void corr_kernel(const double* __restrict__ xt,
                            const double* __restrict__ theta,
                            double* __restrict__ out, int p, int n, int B) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                   threadIdx.x / 32;
  if (row >= p) return;  // the whole warp leaves together
  const double* x = xt + row * static_cast<long>(n);
  double acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.0;
#pragma unroll 4
  for (int k = lane; k < n; k += 32) {
    const double xv = __ldg(x + k);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) acc[b] = fma(xv, __ldg(theta + static_cast<long>(b) * n + k), acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (b < B) {
      double v = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) out[static_cast<long>(b) * p + row] = v;
    }
  }
}

}  // namespace

extern "C" int corr_launch(const void* xt, const void* theta, void* out, int p,
                           int n, int B, int grid, int block, void* stream) {
  corr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xt), static_cast<const double*>(theta),
      static_cast<double*>(out), p, n, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
