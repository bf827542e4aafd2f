// Per-group epsilon-norm Lambda(x_g, alpha_g, R_g) in closed form (paper
// Algorithm 1), and on it the whole SGL dual norm Omega^D of a round in one
// launch: the per-group terms and their maximum per lambda segment.
//
// Replaces: repro/kernels/dual_norm.py::dual_norm_pallas (_dual_norm_kernel)
// and, around it, the ops of repro/kernels/ops.py::sgl_dual_norm_terms_fused
// (epsilons, the divisor tau + (1 - tau) w_g) and the max the solver takes of
// the terms: the Omega^D of every full and compacted certified round and of
// every reduced-gap check between epoch blocks.
//
// Bound on this card: bytes, and at the solver's sizes launch latency.  The
// climate round's (10,512, 7) groups are 589 KB in (0.18 us at 3.35 TB/s);
// the sorted form does ~150 operations per group (0.05 us at 34 TFLOP/s).
// The TPU kernel bisected 64 times, a chain of dependent lane-group sums;
// here the root is the closed form, so the chain is a sort and four scans.
//
// Design.  One lane group of `width` lanes (the power of two >= ng, <= 32)
// per group, one entry per lane in a register, as the bisection had:
//  * each lane holds x_j / ||x||_inf (Lambda is positively homogeneous, so
//    no square of a tiny or huge entry under- or overflows; the root is
//    scaled back at the end); pad lanes hold 0;
//  * a bitonic network of xor-shuffle compare-exchanges sorts the group
//    descending (6 stages at width 8, 15 at width 32); the pads, 0, sort to
//    the tail with the group's own zeros;
//  * inclusive shuffle scans give the prefix sums of core/epsilon_norm.py
//    ::_lam_sorted_core: S, S2 of x and D1, D2 of y = 1 - x;
//  * each lane evaluates its bucket test B_k <= (R / alpha)^2 with x_(k) > 0;
//    j0 = max(1, popcount of the group's ballot), and the root
//    S2_j / (alpha S_j + sqrt(disc)) is read from lane j0 - 1 by shuffle.
// The arithmetic is _lam_sorted_core's line for line (only the prefix sums'
// order differs), and lam's special cases follow in its order: R = 0, then
// alpha = 0, then both (+inf), then ||x||_inf = 0.  A group holding a NaN
// (or an inf, whose scaled entry is inf / inf) gives what lam gives: NaN,
// or ||x||_inf / alpha where R = 0.  Every lane of a group ends with the
// same bits; lane 0 writes.
//
// The SGL entry forms eps_g, alpha = 1 - eps_g, R = eps_g and the divisor
// tau + (1 - tau) w_g from tau and w as core/sgl.py::epsilons and
// group_weight_total do (eps = 0 where the divisor is <= 0; the divisor
// itself is used unguarded), so a round needs no elementwise launches.  The
// grid is (blocks per segment, B): no block straddles two lambdas.  Each
// block reduces its groups' terms (0 for a group whose mask is unset) to one
// partial with a NaN-propagating max, as torch.max, writes it and takes a
// ticket; the last block of the launch reduces the partials, a warp per
// segment, and writes dmax.  The ticket counter is a __device__ word that
// atomicInc returns to 0 at the launch's last ticket, so no launch needs a
// memset; launches on the card must therefore not overlap (the port issues
// them on one stream).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ unsigned int g_tickets = 0;

// max(a, b) that returns NaN if either is NaN, as torch.max / amax.
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// Lambda(x, a, r) of the group whose |x_j| lane l (< width) holds (0 on pad
// lanes); every lane of the group returns the same bits.
__device__ __forceinline__ double group_lambda(double ax, double a, double r,
                                               int width) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (width - 1);
  const unsigned group = width == 32 ? kFull
                                     : ((1u << width) - 1u) << (lane - l);

  double linf = ax;
  for (int off = width / 2; off > 0; off >>= 1)
    linf = nanmax(linf, __shfl_xor_sync(kFull, linf, off, width));
  const double s = linf > 0.0 ? linf : 1.0;
  const double xn = ax / s;
  const bool bad = (__ballot_sync(kFull, xn != xn) & group) != 0u;

  // Bitonic sort, descending: lane l keeps the larger of the pair when its
  // bit j agrees with its bit k (its block of 2k runs descending).
  double v = xn;
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const double o = __shfl_xor_sync(kFull, v, j, width);
      v = (((l & j) == 0) == ((l & k) == 0)) ? fmax(v, o) : fmin(v, o);
    }
  }

  // Inclusive prefix sums over the sorted positions.
  const double y = 1.0 - v;
  double S = v, S2 = v * v, D1 = y, D2 = y * y;
  for (int off = 1; off < width; off <<= 1) {
    const double tS = __shfl_up_sync(kFull, S, off, width);
    const double tS2 = __shfl_up_sync(kFull, S2, off, width);
    const double tD1 = __shfl_up_sync(kFull, D1, off, width);
    const double tD2 = __shfl_up_sync(kFull, D2, off, width);
    if (l >= off) {
      S += tS;
      S2 += tS2;
      D1 += tD1;
      D2 += tD2;
    }
  }

  const double safe_a = a > 0.0 ? a : 1.0;
  const double safe_r = r > 0.0 ? r : 1.0;
  const double k = static_cast<double>(l + 1);
  const double Vk = fmax(D2 - D1 * D1 / k, 0.0);
  const double Bnum = fmax(k * y * y - 2.0 * y * D1 + D2, 0.0);
  const bool pos = v > 0.0;
  const double safe = pos ? v : 1.0;
  const double Bk = pos ? Bnum / (safe * safe) : INFINITY;
  const double ratio = safe_r / safe_a;
  const unsigned pass = __ballot_sync(kFull, pos && Bk <= ratio * ratio);
  const int j0 = max(__popc(pass & group), 1);
  const double Sj = __shfl_sync(kFull, S, j0 - 1, width);
  const double S2j = __shfl_sync(kFull, S2, j0 - 1, width);
  const double Vj = __shfl_sync(kFull, Vk, j0 - 1, width);
  const double total2 = __shfl_sync(kFull, S2, width - 1, width);
  const double disc =
      fmax(safe_r * safe_r * S2j - safe_a * safe_a * j0 * Vj, 0.0);

  double nu = bad ? NAN : S2j / (safe_a * Sj + sqrt(disc)) * s;
  const double l2 = bad ? NAN : s * sqrt(total2);
  if (r == 0.0) nu = linf / safe_a;
  if (a == 0.0) nu = l2 / safe_r;
  if (a == 0.0 && r == 0.0) nu = INFINITY;
  if (linf == 0.0) nu = 0.0;
  return nu;
}

__global__ void __launch_bounds__(kBlock)
    dual_norm_kernel(const double* __restrict__ x,
                     const double* __restrict__ alpha,
                     const double* __restrict__ R, double* __restrict__ out,
                     long G, int ng, int width) {
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long g = tid / width;
  const int j = static_cast<int>(tid % width);
  const bool live = g < G;
  const double ax = (live && j < ng) ? fabs(x[g * ng + j]) : 0.0;
  const double a = live ? alpha[g] : 1.0;
  const double r = live ? R[g] : 1.0;
  const double nu = group_lambda(ax, a, r, width);
  if (live && j == 0) out[g] = nu;
}

// corr (B * Gb, ng), w (Gb,), mask (Gb,) or null -> terms (B * Gb,) and
// dmax (B,); partial holds gridDim.x * B doubles.
__global__ void __launch_bounds__(kBlock)
    sgl_dual_norm_kernel(const double* __restrict__ corr,
                         const double* __restrict__ w,
                         const unsigned char* __restrict__ mask, double tau,
                         double* __restrict__ terms, double* __restrict__ dmax,
                         double* __restrict__ partial, long Gb, int ng,
                         int width) {
  const int per_block = kBlock / width;
  const long g = static_cast<long>(blockIdx.x) * per_block + threadIdx.x / width;
  const int j = threadIdx.x & (width - 1);
  const long row = static_cast<long>(blockIdx.y) * Gb + g;
  const bool live = g < Gb;
  const double ax = (live && j < ng) ? fabs(corr[row * ng + j]) : 0.0;
  const double wg = live ? w[g] : 1.0;
  const double omt = 1.0 - tau;
  const double denom = tau + omt * wg;
  const double eps = denom > 0.0 ? omt * wg / denom : 0.0;
  const double nu = group_lambda(ax, 1.0 - eps, eps, width);
  const double term = nu / denom;

  double v = -INFINITY;
  if (live && j == 0) {
    terms[row] = term;
    v = (mask == nullptr || mask[g]) ? term : 0.0;
  }
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(kFull, v, off));
  __shared__ double warp_max[kWarps];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  const unsigned blocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    double m = warp_max[0];
    for (int i = 1; i < kWarps; ++i) m = nanmax(m, warp_max[i]);
    partial[blockIdx.y * gridDim.x + blockIdx.x] = m;
    __threadfence();
    last = atomicInc(&g_tickets, blocks - 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (unsigned b = warp; b < gridDim.y; b += kWarps) {
    double m = -INFINITY;
    for (unsigned i = lane; i < gridDim.x; i += 32)
      m = nanmax(m, __ldcg(partial + b * gridDim.x + i));
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) dmax[b] = m;
  }
}

}  // namespace

extern "C" int dual_norm_launch(const void* x, const void* alpha, const void* R,
                                void* out, long G, int ng, int width, int grid,
                                void* stream) {
  dual_norm_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(alpha),
      static_cast<const double*>(R), static_cast<double*>(out), G, ng, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgl_dual_norm_launch(const void* corr, const void* w,
                                    const void* mask, double tau, void* terms,
                                    void* dmax, void* partial, long Gb, int ng,
                                    int width, int blocks, int B,
                                    void* stream) {
  sgl_dual_norm_kernel<<<dim3(blocks, B), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(corr), static_cast<const double*>(w),
      static_cast<const unsigned char*>(mask), tau,
      static_cast<double*>(terms), static_cast<double*>(dmax),
      static_cast<double*>(partial), Gb, ng, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dual_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
