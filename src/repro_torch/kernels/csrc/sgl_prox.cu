// Fused two-level Sparse-Group Lasso prox, per row r of beta (rows, ng):
//   out_r = S^gp_{t2_r}( S_{t1_r}(beta_r) ),
//   t1_r = tau lam step_r,  t2_r = (1 - tau) lam w_r step_r,
// with S the elementwise soft-threshold and S^gp the group soft-threshold
// max(1 - t2 / max(||z||, 1e-30), 0) z.  In the batched mode the rows are
// B lambdas times G groups, step_r = lam_b[b] / L (L a scalar or one per
// lambda) and w_r = w[g], formed here, so the batched wrapper copies nothing.
//
// Replaces: repro/kernels/sgl_prox.py::sgl_prox_pallas (_sgl_prox_kernel),
// the prox step of the kernel-timing harness and of ops.sgl_prox_batched (no
// solver path of either package calls it; the BCD kernels do their prox
// inline).
//
// Bound on this card: bytes.  Each entry is read once and written once with
// ~6 operations between, far below the card's operations-per-byte balance;
// the batched climate shape, 8 x (10,512, 7) f64, moves 9.42 MB (2.81 us at
// 3.35 TB/s).  Design: a staged pass, so that every byte moves in 16-byte
// vectors and no lane idles on a padded row.
//  * A block takes a tile of R consecutive rows (the wrapper picks R from
//    32 to 256, as wide as leaves two blocks per SM, and fewer for wide
//    rows: the tile stays within 48 KB of shared memory).  Its R ng entries
//    are contiguous in beta; the block copies them into shared memory with
//    16-byte vector loads, all threads over consecutive vectors.
//  * Alignment: a tile starts on a 16-byte boundary only if its first entry
//    does (for odd ng, every other tile does not).  The tile is placed in
//    shared memory at the same address modulo 16 as in beta, so the vectors
//    inside the tile align on both sides; the at most 16 - sizeof(T) bytes
//    before the first and after the last whole vector move as scalars, and
//    nothing outside the tile is read or written.  out is written the same
//    way when it has beta's alignment modulo 16, else with scalar stores.
//  * One thread per row then soft-thresholds its row in shared memory, sums
//    its squares, and scales it in place; step and w are read from global
//    memory by consecutive threads (coalesced), or formed from lam_b, L, w.
//  * The tile goes back out with 16-byte stores.
// Templated on float and double; the thresholds' scalar factors tau lam and
// (1 - tau) lam arrive in double and are rounded to T once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ T soft(T x, T t) {
  const T m = x > T(0) ? x - t : -x - t;   // |x| - t
  if (m <= T(0)) return T(0);
  return x > T(0) ? m : -m;
}

// Elements of T before the first 16-byte boundary at or after p (<= count).
template <typename T>
__device__ __forceinline__ long head_of(const T* p, long count) {
  const long h = static_cast<long>(
      ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / sizeof(T));
  return h < count ? h : count;
}

// Copies count elements from src to dst, which lie at the same address
// modulo 16: whole 16-byte vectors between, scalars at both ends.
template <typename T>
__device__ __forceinline__ void copy_aligned(T* __restrict__ dst,
                                             const T* __restrict__ src,
                                             long count) {
  constexpr long kVec = 16 / sizeof(T);
  const long head = head_of(src, count);
  const long vecs = (count - head) / kVec;
  const long tail = head + vecs * kVec;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (long i = threadIdx.x; i < vecs; i += blockDim.x) d4[i] = s4[i];
  const long t = threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (tail + t < count) dst[tail + t] = src[tail + t];
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kBlock)
    sgl_prox_kernel(const T* __restrict__ beta, const T* __restrict__ step,
                    const T* __restrict__ w, const T* __restrict__ L,
                    int L_per_lambda, T L_scalar, T* __restrict__ out,
                    long rows, long G, int ng, int tile_rows, T c1, T c2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long r0 = static_cast<long>(blockIdx.x) * tile_rows;
  const long left = rows - r0;
  const int nr = static_cast<int>(left < tile_rows ? left : tile_rows);
  const long count = static_cast<long>(nr) * ng;
  const T* src = beta + r0 * ng;
  T* tile = reinterpret_cast<T*>(smem + (reinterpret_cast<uintptr_t>(src) & 15u));
  copy_aligned(tile, src, count);
  __syncthreads();

  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const long row = r0 + r;
    T s, wr;
    if (kBatched) {
      const long b = row / G;
      s = step[b] / (L == nullptr ? L_scalar : L[L_per_lambda ? b : 0]);
      wr = w[row - b * G];
    } else {
      s = step[row];
      wr = w[row];
    }
    const T t1 = c1 * s;
    const T t2 = c2 * wr * s;
    T* v = tile + static_cast<long>(r) * ng;
    T acc = T(0);
    for (int j = 0; j < ng; ++j) {
      const T z = soft(v[j], t1);
      v[j] = z;
      acc += z * z;
    }
    const T nrm = sqrt(acc);
    const T floor_nrm = nrm > T(1e-30) ? nrm : T(1e-30);
    const T q = T(1) - t2 / floor_nrm;
    const T scale = q > T(0) ? q : T(0);
    for (int j = 0; j < ng; ++j) v[j] = scale * v[j];
  }
  __syncthreads();

  T* dst = out + r0 * ng;
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) &
       15u) == 0) {
    copy_aligned(dst, tile, count);
  } else {
    for (long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = tile[i];
  }
}

template <typename T>
int launch(const void* beta, const void* step, const void* w, const void* L,
           int L_per_lambda, double L_scalar, void* out, long rows, long G,
           int ng, int tile_rows, double c1, double c2, int batched, int grid,
           int smem, cudaStream_t s) {
  const T* b = static_cast<const T*>(beta);
  const T* st = static_cast<const T*>(step);
  const T* ww = static_cast<const T*>(w);
  const T* LL = static_cast<const T*>(L);
  T* o = static_cast<T*>(out);
  if (batched) {
    sgl_prox_kernel<T, true><<<grid, kBlock, smem, s>>>(
        b, st, ww, LL, L_per_lambda, static_cast<T>(L_scalar), o, rows, G, ng,
        tile_rows, static_cast<T>(c1), static_cast<T>(c2));
  } else {
    sgl_prox_kernel<T, false><<<grid, kBlock, smem, s>>>(
        b, st, ww, LL, L_per_lambda, static_cast<T>(L_scalar), o, rows, G, ng,
        tile_rows, static_cast<T>(c1), static_cast<T>(c2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c1 = tau * lam, c2 = (1 - tau) * lam; is_f64 selects the element type of
// beta, step, w, L and out.  batched = 0: step and w have one entry per row.
// batched = 1: the rows are B blocks of G; step holds lam_b (B,), w (G,),
// and L is L_scalar (L null) or L[b] (L_per_lambda) or L[0].
extern "C" int sgl_prox_launch(const void* beta, const void* step,
                               const void* w, const void* L, int L_per_lambda,
                               double L_scalar, void* out, long rows, long G,
                               int ng, int tile_rows, double c1, double c2,
                               int is_f64, int batched, int grid, int smem,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return launch<double>(beta, step, w, L, L_per_lambda, L_scalar, out, rows,
                          G, ng, tile_rows, c1, c2, batched, grid, smem, s);
  }
  return launch<float>(beta, step, w, L, L_per_lambda, L_scalar, out, rows, G,
                       ng, tile_rows, c1, c2, batched, grid, smem, s);
}

extern "C" const char* sgl_prox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
