// Per-group epsilon-norm Lambda(x_g, alpha_g, R_g) by fixed-count bisection.
//
// Replaces: repro/kernels/dual_norm.py::dual_norm_pallas (_dual_norm_kernel),
// the Omega^D terms of every full and compacted certified round.
//
// Lambda is the positive root of g(nu) = sum_i S_{nu alpha}(x_i)^2 - (nu R)^2,
// bracketed in [linf / (alpha + R), linf / alpha]; 64 halvings reach f64
// roundoff.  The special cases are applied after the loop in the TPU
// kernel's order: R == 0, then alpha == 0, then linf == 0.
//
// Bound on this card: latency, not bytes (G = 10,512 groups of 7 is 589 KB
// in).  The 64 steps form a dependent chain, so the design spreads the work
// as wide as the data allows: one group of `width` lanes (the power of two
// >= ng, <= 32) per group, one entry per lane held in a register for the
// whole loop, and xor-shuffle sums inside the lane group each step.  An xor
// butterfly gives every lane the bit-identical sum, so all lanes of a group
// take the same branch of the bisection.  Lanes past the last group run the
// loop on inert values (alpha = R = 1, x = 0) so every shuffle has its full
// warp, and write nothing.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double group_sum(double v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

__device__ __forceinline__ double group_max(double v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off, width));
  return v;
}

__global__ void dual_norm_kernel(const double* __restrict__ x,
                                 const double* __restrict__ alpha,
                                 const double* __restrict__ R,
                                 double* __restrict__ out, int G, int ng,
                                 int width, int n_iter) {
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long g = tid / width;
  const int j = static_cast<int>(tid % width);
  const bool live = g < G;
  const double ax = (live && j < ng) ? fabs(x[g * ng + j]) : 0.0;
  const double a = live ? alpha[g] : 1.0;
  const double r = live ? R[g] : 1.0;

  const double linf = group_max(ax, width);
  const double safe_a = a > 0.0 ? a : 1.0;
  const double safe_R = r > 0.0 ? r : 1.0;
  double lo = linf / (safe_a + safe_R);
  double hi = linf / safe_a;
  for (int it = 0; it < n_iter; ++it) {
    const double mid = 0.5 * (lo + hi);
    const double st = fmax(ax - mid * safe_a, 0.0);
    const double mr = mid * safe_R;
    const double gv = group_sum(st * st, width) - mr * mr;
    if (gv > 0.0) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  double nu = 0.5 * (lo + hi);
  const double l2 = sqrt(group_sum(ax * ax, width));
  if (r == 0.0) nu = linf / safe_a;
  if (a == 0.0) nu = l2 / safe_R;
  if (linf == 0.0) nu = 0.0;
  if (live && j == 0) out[g] = nu;
}

}  // namespace

extern "C" int dual_norm_launch(const void* x, const void* alpha, const void* R,
                                void* out, int G, int ng, int width, int n_iter,
                                int grid, int block, void* stream) {
  dual_norm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(alpha),
      static_cast<const double*>(R), static_cast<double*>(out), G, ng, width,
      n_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dual_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
