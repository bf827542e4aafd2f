// Fused two-level Sparse-Group Lasso prox, per row g of beta (G, ng):
//   out_g = S^gp_{t2_g}( S_{t1_g}(beta_g) ),
//   t1_g = tau lam step_g,  t2_g = (1 - tau) lam w_g step_g,
// with S the elementwise soft-threshold and S^gp the group soft-threshold
// max(1 - t2 / max(||z||, 1e-30), 0) z.
//
// Replaces: repro/kernels/sgl_prox.py::sgl_prox_pallas (_sgl_prox_kernel),
// the prox step the kernel-timing harness times (no solver path of either
// package calls it; the BCD kernels do their prox inline).
//
// Bound on this card: bytes (and, at the shapes used, launch latency).
// Each entry is read once and written once with ~6 operations between, far
// below the card's operations-per-byte balance; (4,096, 8) f64 moves 0.59 MB
// (0.18 us at 3.35 TB/s).  Design: dual_norm.cu's.  Each row gets a lane
// group of `width` lanes (the power of two >= ng, at most 32) inside one
// warp; lane j holds entry j in a register, soft-thresholds it there, and
// the row's squared norm is an xor-shuffle sum inside the lane group (every
// lane gets the same bits, so all agree on the group scale).  Rows wider
// than 32 take a whole warp: each lane also loops over entries j + 32,
// j + 64, ... (re-read for the write, from L1).  Consecutive lanes read
// consecutive entries, so the loads coalesce.  Lanes past the last row run
// the shuffles on zeros and write nothing, so the ragged edge is masked
// here (no padding of G with step = w = 1, as the TPU wrapper pads).
// Templated on float and double; the thresholds' scalar factors tau lam
// and (1 - tau) lam arrive in double and are rounded to T once.
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

template <typename T>
__device__ __forceinline__ T soft(T x, T t) {
  const T m = x > T(0) ? x - t : -x - t;   // |x| - t
  if (m <= T(0)) return T(0);
  return x > T(0) ? m : -m;
}

template <typename T>
__global__ void sgl_prox_kernel(const T* __restrict__ beta,
                                const T* __restrict__ step,
                                const T* __restrict__ w, T* __restrict__ out,
                                long G, int ng, int width, T c1, T c2) {
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long g = tid / width;
  const int j = static_cast<int>(tid % width);
  const bool live = g < G;
  const long base = g * ng;
  T t1 = T(0), t2 = T(0);
  if (live) {
    const T s = step[g];
    t1 = c1 * s;
    t2 = c2 * w[g] * s;
  }
  const T z0 = (live && j < ng) ? soft(beta[base + j], t1) : T(0);
  T acc = z0 * z0;
  if (live) {
    for (int k = j + width; k < ng; k += width) {
      const T z = soft(beta[base + k], t1);
      acc += z * z;
    }
  }
  const T nrm = sqrt(group_sum(acc, width));
  const T floor_nrm = nrm > T(1e-30) ? nrm : T(1e-30);
  const T r = T(1) - t2 / floor_nrm;
  const T scale = r > T(0) ? r : T(0);
  if (!live) return;
  if (j < ng) out[base + j] = scale * z0;
  for (int k = j + width; k < ng; k += width)
    out[base + k] = scale * soft(beta[base + k], t1);
}

}  // namespace

// c1 = tau * lam, c2 = (1 - tau) * lam; is_f64 selects the element type of
// beta, step, w and out.
extern "C" int sgl_prox_launch(const void* beta, const void* step,
                               const void* w, void* out, long G, int ng,
                               int width, double c1, double c2, int is_f64,
                               int grid, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    sgl_prox_kernel<double><<<grid, block, 0, s>>>(
        static_cast<const double*>(beta), static_cast<const double*>(step),
        static_cast<const double*>(w), static_cast<double*>(out), G, ng,
        width, c1, c2);
  } else {
    sgl_prox_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(beta), static_cast<const float*>(step),
        static_cast<const float*>(w), static_cast<float*>(out), G, ng, width,
        static_cast<float>(c1), static_cast<float>(c2));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgl_prox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
