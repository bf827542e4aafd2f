// Correlation matvec corr[b, r] = sum_k Xt[r, k] * theta[b, k] in f64.
//
// Replaces: repro/kernels/screening_scores.py::screening_corr_pallas
// (_corr_kernel), the X^T resid correlation of every certified round, of the
// reduced-gap checks between epoch blocks and, batched over B <= 8
// residuals, of the batched-lambda driver.
//
// Bound on this card: bytes.  Each design element is used once per residual,
// so even at B = 8 the kernel does 2 B flops per 8 bytes read, far below the
// ~10 f64 flops per byte at which the CUDA cores would bound it; the (p, n)
// design (479 MB at the climate width p = 73,584, n = 814) streamed once
// over HBM is the floor.
//
// Design: a persistent matvec fed by the Tensor Memory Accelerator.
//  * B is a template parameter (1..8; the launcher switches on it), so a
//    single residual carries one accumulator per row and no dead branches.
//  * theta is read once per CTA and column chunk: into shared memory for
//    B = 1, into registers for B >= 2 (below).  Where n exceeds a chunk
//    (4,096 columns at B = 1, 1,024 from B = 2 on), the CTA walks its tiles
//    once per chunk; later chunks add into the rows the CTA wrote (any n
//    works).
//  * One CTA per SM walks tiles t = blockIdx.x, blockIdx.x + grid, ... of R
//    consecutive design rows (an even split of the rows per CTA measured
//    no faster: neighbouring CTAs then read far-apart rows).  A producer
//    warp puts each tile into shared memory with cp.async.bulk (one bulk
//    copy per row, one row per lane) into a ring of S stages; a stage's
//    full mbarrier counts its bytes in, its empty mbarrier counts the 8
//    consumer warps out, and the producer refills it as soon as the last
//    one leaves, with no CTA-wide barrier per tile.  Bulk copies, not 16-byte vector loads: they cost the
//    consumers no registers and no issue slots, and one lane keeps a whole
//    row in flight.  The wrapper's geometry takes two stages of ~80 KB
//    (12 rows of the climate design), one in flight while the other is
//    reduced: on the card that beat 3 or 4 smaller stages.
//  * Alignment: a bulk copy wants 16-byte aligned addresses and sizes, and a
//    row start is 16-byte aligned only when n (or the chunk's start) is even.
//    Each row copy therefore covers the 16-byte granules that hold the row:
//    it starts at most 8 bytes early and ends at most 8 bytes late, and the
//    consumers skip the one-double shift.  A granule that holds a byte of
//    the design never leaves its allocation (the wrapper requires a 16-byte
//    aligned design, and allocations are 512-byte granular).
//  * B = 1: a warp per row of the tile, lanes over consecutive doubles, one
//    accumulator, a xor-shuffle sum, one lane writes the corr entry once.
//    The tensor-core body below would serve one residual too (theta's rows
//    past B are zero), but it measured 4% slower at the climate shape
//    (B = 2 through it 0.1651 ms, B = 1 through this body 0.1587, each
//    within 1% over six readings; tools/bcd_step_cost_torch.py, H100 SXM
//    at 700 W), so B = 1 keeps its own body.
//  * B >= 2: the f64 tensor cores (mma.m8n8k4): theta's 8 rows (zero past
//    B) times 4 columns against the design's 8 rows, so every staged value
//    serves all B residuals from a register and no shuffle sums are left.
//    With lanes over columns instead, each design value would need B theta
//    loads from shared memory and B shuffle sums per row: at B = 8 five
//    bytes of shared-memory traffic per byte of design, and a B = 8 launch
//    took 1.8x the time of a B = 1 launch on the card.  Warp w takes the
//    4-column blocks w, w + 8, ... of every 8-row block of a tile, so its
//    theta fragments are the same for every tile: the first 32 of them stay
//    in registers for the whole column chunk, and an mma reads only the
//    design from shared memory.  The 8 warps' shares land in shared memory
//    and, once the consumer warps have met at a named barrier, are added in
//    warp order; each corr entry is written once (per column chunk).  (A
//    warp per whole 8-row block, with no shares to add, measured 15%
//    slower: two warps per tile, each on a long mma chain.)  Rows in shared memory are 16 m + 4 doubles apart, so a
//    fragment's 8 rows fall in distinct banks.
//  * Rows past p are never copied nor written: no padding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_query.cuh"

namespace {

constexpr int kWarps = 8;                  // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A stage that never lands is
// a bug; after ~2^36 cycles (tens of seconds) the launch fails with a trap
// instead of holding the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t polls = 1;; ++polls) {
    uint32_t ready;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (ready) return;
    if ((polls & 1023) == 0) {
      const long long now = clock64();
      if (start == 0) {
        start = now;
      } else if (now - start > (1LL << 36)) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// A barrier of the consumer warps alone (named barrier 1), so the producer
// warp never waits on them.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 16-byte granules holding doubles [a, a + count): start and length.
__device__ __forceinline__ void granules(const double* a, int count,
                                         const char** src, uint32_t* bytes) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15);
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(a + count) + 15) & ~uintptr_t(15);
  *src = reinterpret_cast<const char*>(lo);
  *bytes = static_cast<uint32_t>(hi - lo);
}

__device__ __forceinline__ int shift_of(const double* a) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(a) >> 3) & 1);
}

// CTA c walks tiles t = c, c + grid, c + 2 grid, ... of R rows (the last
// tile of the design shorter), once per column chunk: neighbouring CTAs
// read neighbouring rows at the same time.
struct Walk {
  int p, n, nc, R, S, my_t, grid;
  __device__ int chunk(int it) const { return it / my_t; }
  __device__ int row0(int it) const {
    return (static_cast<int>(blockIdx.x) + (it % my_t) * grid) * R;
  }
  __device__ int rows(int it) const { return min(R, p - row0(it)); }
};

// The producer warp issues item ``it`` into its ring slot: lane 0 arms the
// full barrier with the bytes of every row copy, then the lanes copy one row
// each.
__device__ void issue(const Walk& wk, const double* __restrict__ xt,
                      double* ring, uint64_t* full, int pitch, int it,
                      int lane) {
  const int slot = it % wk.S;
  const int ch = wk.chunk(it);
  const int r0 = wk.row0(it);
  const int rows = wk.rows(it);
  const int c0 = ch * wk.nc;
  const int ncols = min(wk.nc, wk.n - c0);
  uint32_t total = 0;
  for (int r = lane; r < rows; r += 32) {
    const char* src;
    uint32_t bytes;
    granules(xt + static_cast<long>(r0 + r) * wk.n + c0, ncols, &src, &bytes);
    total += bytes;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
  if (lane == 0) mbar_expect(full + slot, total);
  __syncwarp();
  double* stage = ring + static_cast<long>(slot) * wk.R * pitch;
  for (int r = lane; r < rows; r += 32) {
    const char* src;
    uint32_t bytes;
    granules(xt + static_cast<long>(r0 + r) * wk.n + c0, ncols, &src, &bytes);
    bulk_copy(stage + static_cast<long>(r) * pitch, src, bytes, full + slot);
  }
}

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Doubles from row start to row start in shared memory: a multiple of 16
// plus 4, so the 8 rows (or theta rows) a tensor-core fragment reads fall in
// different banks.
__host__ __device__ __forceinline__ int pitch_of(int len) {
  return len + ((4 - len) & 15);
}

template <int B>
__global__ void __launch_bounds__(kThreads, 1)
    corr_kernel(const double* __restrict__ xt, const double* __restrict__ theta,
                double* __restrict__ out, int p, int n, int nc, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncp = (nc + 1) & ~1;         // theta chunk width, even
  const int tp = pitch_of(ncp);          // theta row in shared memory
  const int pitch = pitch_of(ncp + 2);   // staged row: the row, its shift
  // B >= 2: warp w takes the column share of 4-column blocks w, w + 8, ...
  // of every 8-row block of a tile; its shares land in red.
  const int nrb = (R + 7) / 8;
  // theta's chunk: in shared memory for B = 1; for B >= 2 in registers
  // (below), read from global memory once per chunk.
  double* th = reinterpret_cast<double*>(smem_raw);          // [1][tp]
  double* ring = th + (B == 1 ? tp : 0);                     // [S][R][pitch]
  double* red = ring + static_cast<long>(S) * R * pitch;  // [2][8][nrb][64]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + (B >= 2 ? 2 * kWarps * nrb * 64 : 0));
  uint64_t* empty = full + S;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Walk wk;
  wk.p = p;
  wk.n = n;
  wk.nc = nc;
  wk.R = R;
  wk.S = S;
  wk.grid = gridDim.x;
  const int tiles = (p + R - 1) / R;
  wk.my_t = static_cast<int>(blockIdx.x) < tiles
                ? (tiles - 1 - static_cast<int>(blockIdx.x)) / wk.grid + 1
                : 0;
  const int n_chunks = (n + nc - 1) / nc;
  const int items = n_chunks * wk.my_t;
  if (items == 0) return;  // the whole CTA leaves: nothing was armed

  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    // The producer: refill a stage as soon as all consumer warps let go of
    // it (its k-th reuse waits for the empty barrier's (k - 1)-th phase).
    for (int it = 0; it < items; ++it) {
      if (it >= S) mbar_wait(empty + it % S, static_cast<uint32_t>((it / S - 1) & 1));
      issue(wk, xt, ring, full, pitch, it, lane);
    }
    return;
  }

  // B >= 2: the column shares of item `it` are in red[it & 1]; add them in
  // share order and write (chunk 0) or add into (later chunks) corr.
  auto finish = [&](int it) {
    const int r0 = wk.row0(it);
    const int rows = wk.rows(it);
    const int ch = wk.chunk(it);
    const double* rd = red + (it & 1) * kWarps * nrb * 64;
    for (int i = t; i < nrb * 64; i += kWarps * 32) {
      const int rb = i >> 6, e = i & 63;
      const int b = e >> 3, row = rb * 8 + ((e >> 1) & 3) * 2 + (e & 1);
      if (b < B && row < rows) {
        double v = 0.0;
        for (int cp = 0; cp < kWarps; ++cp) v += rd[(cp * nrb + rb) * 64 + e];
        double* o = out + static_cast<long>(b) * p + r0 + row;
        *o = ch == 0 ? v : *o + v;
      }
    }
  };
  // B >= 2: this warp's theta fragments (residual gid, column 4 kb + tig of
  // its blocks kb = warp + 8 i, i < 32: the whole chunk of at most 1,024
  // columns), in registers for the whole column chunk: an mma reads only
  // the design from shared memory.
  constexpr int kCached = B >= 2 ? 32 : 1;
  double ta[kCached];
  const int gid = lane >> 2, tig = lane & 3;

  for (int it = 0; it < items; ++it) {
    const int ch = wk.chunk(it);
    const int c0 = ch * nc;
    const int ncols = min(nc, n - c0);
    if (it % wk.my_t == 0) {  // a new column chunk: theta's chunk
      if constexpr (B == 1) {
        consumers_sync();
        for (int k = t; k < ncols; k += kWarps * 32) th[k] = __ldg(theta + c0 + k);
        consumers_sync();
      } else {
#pragma unroll
        for (int i = 0; i < kCached; ++i) {
          const int k = (warp + kWarps * i) * 4 + tig;
          ta[i] = gid < B && k < ncols
                      ? __ldg(theta + static_cast<long>(gid) * n + c0 + k)
                      : 0.0;
        }
      }
    }
    const int slot = it % S;
    mbar_wait(full + slot, static_cast<uint32_t>((it / S) & 1));
    const int r0 = wk.row0(it);
    const int rows = wk.rows(it);
    const double* stage = ring + static_cast<long>(slot) * R * pitch;
    auto row_of = [&](int r) {  // staged row r, past its shift
      return stage + static_cast<long>(r) * pitch +
             shift_of(xt + static_cast<long>(r0 + r) * n + c0);
    };
    if constexpr (B == 1) {
      // A warp per row, lanes over consecutive doubles, one accumulator.
      for (int r = warp; r < rows; r += kWarps) {
        const double* xr = row_of(r);
        double acc = 0.0;
#pragma unroll 4
        for (int k = lane; k < ncols; k += 32) acc = fma(xr[k], th[k], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        if (lane == 0) {
          double* o = out + r0 + r;
          *o = ch == 0 ? acc : *o + acc;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    } else {
      // f64 tensor cores, mma m8n8k4: A = theta (8 residuals x 4 columns,
      // rows past B zero), B = the staged design (4 columns x 8 rows).
      for (int rb = 0; rb * 8 < rows; ++rb) {
        const int row = rb * 8 + gid;
        const bool rv = row < rows;
        const double* xr = row_of(rv ? row : rows - 1);
        double d[4][2] = {};               // four chains, added at the end
#pragma unroll
        for (int i = 0; i < kCached; ++i) {
          const int kb = warp + kWarps * i;
          if (kb * 4 < ncols) {
            const int k = kb * 4 + tig;
            const double x = rv && k < ncols ? xr[k] : 0.0;
            dmma(d[i & 3][0], d[i & 3][1], ta[i], x);
          }
        }
        double* rd = red + ((it & 1) * kWarps * nrb + warp * nrb + rb) * 64 +
                     lane * 2;
        rd[0] = (d[0][0] + d[1][0]) + (d[2][0] + d[3][0]);
        rd[1] = (d[0][1] + d[1][1]) + (d[2][1] + d[3][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      consumers_sync();   // every share of this tile is in red[it & 1]
      finish(it);
    }
  }
}

using CorrKernel = void (*)(const double*, const double*, double*, int, int,
                            int, int, int);

CorrKernel corr_instance(int B) {
  switch (B) {
    case 1: return corr_kernel<1>;
    case 2: return corr_kernel<2>;
    case 3: return corr_kernel<3>;
    case 4: return corr_kernel<4>;
    case 5: return corr_kernel<5>;
    case 6: return corr_kernel<6>;
    case 7: return corr_kernel<7>;
    case 8: return corr_kernel<8>;
    default: return nullptr;
  }
}

// Shared memory of one CTA: theta's chunk (B = 1), the ring, the
// tensor-core column shares (B >= 2), the ring's full and empty barriers.
long corr_smem_bytes(int B, int nc, int R, int S) {
  const int ncp = (nc + 1) & ~1;
  const int nrb = (R + 7) / 8;
  return 8L * ((B == 1 ? pitch_of(ncp) : 0) +
               static_cast<long>(S) * R * pitch_of(ncp + 2) +
               (B >= 2 ? 2L * kWarps * nrb * 64 : 0)) +
         16L * S;
}

}  // namespace

extern "C" int corr_launch(const void* xt, const void* theta, void* out, int p,
                           int n, int B, int nc, int R, int S, int grid,
                           int smem_bytes, void* stream) {
  const CorrKernel kernel = corr_instance(B);
  // From B = 2 on a chunk is at most 8 warps x 32 cached blocks x 4 columns.
  if (kernel == nullptr || nc < 1 || (B >= 2 && nc > 1024) || R < 1 ||
      S < 1 || grid < 1 || corr_smem_bytes(B, nc, R, S) != smem_bytes ||
      (reinterpret_cast<uintptr_t>(xt) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xt), static_cast<const double*>(theta),
      static_cast<double*>(out), p, n, nc, R, S);
  return static_cast<int>(cudaGetLastError());
}

// The static audit's queries (launch_query.cuh); variant = B.
extern "C" int corr_func_attributes(int variant, int* out) {
  const CorrKernel kernel = corr_instance(variant);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return write_func_attributes(kernel, out);
}

extern "C" int corr_max_active_blocks(int variant, int block, int smem) {
  const CorrKernel kernel = corr_instance(variant);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_blocks(kernel, block, smem);
}

extern "C" const char* corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
