// Shared body of the fused cyclic BCD epoch kernels: bcd_epoch.cu (least
// squares) and bcd_epoch_logistic.cu (logistic loss) each instantiate it
// once.  bcd_epoch.cu's header gives the update, the bound and the chunked
// evaluation; this file is the design on the card.
//
// One thread-block cluster of C CTAs per lambda (grid B * C, cluster C).
// CTA `rank` owns the samples [j0, j1) = [rank n / C, (rank + 1) n / C) and
// keeps its slice of the carry in its own shared memory for the whole
// launch:
//   kLogistic = false: the residual r; the gradient reads r, the step is on
//     L_g, and a changed group moves r by X_g (beta_old - beta_new);
//   kLogistic = true: the linear predictor z and rho = y - sigmoid(z); the
//     gradient reads rho, the step is on L_g / 4, a changed group moves z by
//     X_g (beta_new - beta_old) and the thread that moves z[j] recomputes
//     rho[j] (rho is a function of z alone, so every group still reads the
//     fresh rho of the serial order).
//
// The design ring.  X_g is (n, ng) row-major inside (Gb, n, ng), so a CTA's
// slice of X_g is the contiguous range (g n + j0) ng ... (g n + j1) ng.  The
// design does not depend on the carry, so the lanes of warp 0 stream the
// slices of the groups ahead, in the serial order (epoch by epoch), into a
// ring of S stages by cp.async.bulk, each stage completed on its own
// mbarrier (phase parity = item / S).  A chunk's K groups are all resident
// before it starts; when a chunk ends at its first changed group k*, the
// stages of the groups after k* stay in the ring and are read again, not
// fetched again; a stage is refilled only once the serial order has passed
// its group, while the cluster barrier of the next chunk gathers.  The sweep
// ends at the last live group Gl - 1 (L_g > 0; every CTA finds it from L_g
// at the start): a bucket's inert padding sits at its tail and is neither
// fetched nor reduced.  Inert groups before it are fetched and reduced like
// the others (a look at L_g would put a global load on the issuing warp)
// and keep beta_g bit for bit.  A bulk copy wants 16-byte aligned addresses
// and sizes, and a slice starts on an odd double whenever (g n + j0) ng is odd
// (n = 814, ng = 7 at j0 odd): each copy covers the 16-byte granules that
// hold the slice, starting at most 8 bytes early, and the readers skip that
// one-double shift.  A granule that holds a byte of the design never leaves
// its allocation (the wrapper requires a 16-byte aligned design).  Where a
// slice is too large for a ring of 8 stages beside the carry (S = 0: n / C
// large at ng = 32), the same code reads the slices from global memory.
//
// One chunk of K consecutive groups (K adapts as before: doubled after a
// chunk where nothing changed, halved after one whose first group changed):
//   A. team k (16 / K warps) sums its CTA's slice of X_g^T gv for group
//      g0 + k from the staged tile: lanes over consecutive doubles, the
//      feature of flat element e is e mod ng, so each lane keeps one
//      accumulator (lanes past the largest multiple of ng below 32 idle);
//      the lanes of one feature are folded by shuffles in a fixed tree.
//      Nothing here waits on global memory: L_g, w_g and the mask row of
//      warp k's group were loaded during the previous chunk.
//   B. the team's per-feature partials (combined over its warps in order)
//      land in this CTA's exchange buffer, double-buffered by chunk parity.
//   -- barrier.cluster (release / acquire): the cluster's one barrier per
//      chunk; between its arrive and its wait, beta_g is read and the ring
//      refilled.
//   C. warp k adds the C partials of its group over distributed shared
//      memory, rank 0 to C - 1 (a fixed order), and applies both
//      soft-thresholds.  Every CTA does this with the same inputs and the
//      same instructions, so every CTA gets the same bits: no broadcast of
//      beta_g and no disagreement about which group changed.
//   D. the first changed group k* of the chunk (if any) is recorded, and
//      each CTA moves its own slice of the carry from the tile still in
//      shared memory: X_g is read from global memory once per step.
// beta lives in shared memory (a full copy per CTA) when Gb * ng fits beside
// a ring of at least 16 stages; else in the global output, which the wrapper
// fills with beta0 and every CTA of the cluster updates with the same
// values.  A changed beta_g is written only after the next chunk's cluster
// wait: by then every CTA has read the betas of the chunk that changed it
// (their reads come before their next arrive), so no read meets another
// CTA's write; a group of the next chunk that is the changed one (a buffer
// of at most K groups) takes the pending value.
// No float atomics anywhere: two launches give the same bits.
#pragma once
#include <cooperative_groups.h>

#include "launch_query.cuh"
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 16;   // groups per chunk
constexpr int kMaxC = 16;   // CTAs per cluster
constexpr unsigned kFull = 0xffffffffu;

// The logistic function in f64, in the two-branch form that never overflows.
__device__ __forceinline__ double sigmoid(double v) {
  if (v >= 0.0) return 1.0 / (1.0 + exp(-v));
  const double e = exp(v);
  return e / (1.0 + e);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int shift_of(const double* a) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(a) >> 3) & 1);
}

__host__ __device__ __forceinline__ long r16(long bytes) {
  return (bytes + 15) & ~15L;
}

// Byte offsets of the shared-memory regions; every CTA of a cluster has the
// same layout, so one offset names the exchange buffer in all of them.  The
// wrapper's geometry computes the same total, and the launcher checks it.
struct Layout {
  long xpart, wpart, cand_nb, cand_d, pend, flags, carry, beta, ring, bars,
      total;
  __host__ __device__ Layout(int carries, int m_max, int Gb, int ng, int S,
                             int stage, int beta_in_smem) {
    xpart = 0;                                      // [2][kMaxK][32]
    wpart = xpart + 8L * 2 * kMaxK * 32;            // [kWarps][32]
    cand_nb = wpart + 8L * kWarps * 32;             // [kMaxK][32]
    cand_d = cand_nb + 8L * kMaxK * 32;             // [kMaxK][32]
    pend = cand_d + 8L * kMaxK * 32;                // [32], its group, Gl
    flags = pend + 8L * 32 + 16;                    // [kMaxK] int
    carry = flags + r16(4L * kMaxK);                // carries * m_max
    beta = carry + r16(8L * carries * m_max);       // Gb * ng if in smem
    ring = beta + (beta_in_smem ? r16(8L * Gb * ng) : 0);  // S * stage
    bars = ring + 8L * S * stage;                   // S mbarriers
    total = bars + 8L * S;
  }
};

template <bool kLogistic>
__global__ void __launch_bounds__(kThreads, 1) bcd_chunk_kernel(
    const double* __restrict__ xt,      // (Gb, n, ng) compacted design
    const double* __restrict__ Lg,      // (Gb,) block Lipschitz constants
    const double* __restrict__ w,       // (Gb,) group weights
    const double* __restrict__ fmask,   // (B, Gb, ng) float feature masks
    const double* __restrict__ lam,     // (B,)
    double tau,
    const double* __restrict__ y,       // (n,) labels (logistic only)
    const double* __restrict__ beta0,   // (B, Gb, ng) warm start
    const double* __restrict__ carry0,  // (B, n) residual or predictor
    double* beta,                       // (B, Gb, ng) out (beta0's copy
                                        //   when beta stays global)
    double* __restrict__ carry,         // (B, n) out
    int Gb, int n, int ng, int n_epochs, int C, int S, int stage, int Kmax,
    int beta_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kCarries = kLogistic ? 2 : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int j0 = static_cast<int>(static_cast<long>(rank) * n / C);
  const int m = static_cast<int>(static_cast<long>(rank + 1) * n / C) - j0;
  const int m_max = (n + C - 1) / C;
  const Layout L(kCarries, m_max, Gb, ng, S, stage, beta_in_smem);
  double* xpart = reinterpret_cast<double*>(smem_raw + L.xpart);
  double* wpart = reinterpret_cast<double*>(smem_raw + L.wpart);
  double* cand_nb = reinterpret_cast<double*>(smem_raw + L.cand_nb);
  double* cand_d = reinterpret_cast<double*>(smem_raw + L.cand_d);
  double* pend_nb = reinterpret_cast<double*>(smem_raw + L.pend);
  int* pend_g = reinterpret_cast<int*>(pend_nb + 32);
  int* live_end = pend_g + 1;
  int* flags = reinterpret_cast<int*>(smem_raw + L.flags);
  double* c = reinterpret_cast<double*>(smem_raw + L.carry);  // m
  double* gv = kLogistic ? c + m_max : c;  // m: the vector gradients read
  double* ring = reinterpret_cast<double*>(smem_raw + L.ring);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + L.bars);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long boff = static_cast<long>(b) * Gb * ng;
  double* bet = beta_in_smem ? reinterpret_cast<double*>(smem_raw + L.beta)
                             : beta + boff;
  const double* fm = fmask + boff;
  const double Lscale = kLogistic ? 0.25 : 1.0;  // nu of the loss
  const int mng = m * ng;
  const int reps = 32 / ng;            // lanes per feature in a warp
  const int Lw = reps * ng;            // active lanes of a warp

  if (t == 0) {
    *live_end = 0;
    for (int i = 0; i < S; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(bars + i)),
                   "r"(1u)
                   : "memory");
    }
    if (S > 0) asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Gl: one past the last live group.  The groups after it are inert, so
  // the sweep stops there (their beta is beta0's, bit for bit).
  {
    int last = 0;
    for (int g = t; g < Gb; g += kThreads) {
      if (__ldg(Lg + g) > 0.0) last = g + 1;
    }
    last = __reduce_max_sync(kFull, last);
    if (lane == 0 && last > 0) atomicMax(live_end, last);
  }
  __syncthreads();
  const int Gl = *live_end;
  const int total = n_epochs * Gl;    // ring items (the launcher caps it)

  // The slice of group g this CTA reads, in global memory.
  auto slice = [&](int g) {
    return xt + (static_cast<long>(g) * n + j0) * ng;
  };
  // A lane of warp 0 puts item s (group s mod Gl) into its stage.  Every
  // swept group's slice is copied, inert ones too: a look at L_g here would
  // put a global load on the issuing warp's path once per item.
  auto issue = [&](int s) {
    uint64_t* bar = bars + s % S;
    const uint32_t bar_a = smem_addr(bar);
    if (mng == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar_a)
                   : "memory");
      return;
    }
    const double* a = slice(s % Gl);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15);
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(a + mng) + 15) & ~uintptr_t(15);
    const uint32_t bytes = static_cast<uint32_t>(hi - lo);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar_a),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(ring + (s % S) * stage)),
        "l"(lo), "r"(bytes), "r"(bar_a)
        : "memory");
  };
  // Item s's slice of X_g, once it landed (with no ring: in global memory).
  auto tile = [&](int s) -> const double* {
    const int g = s % Gl;
    if (S == 0) return slice(g);
    mbar_wait(bars + s % S, static_cast<uint32_t>((s / S) & 1));
    return ring + (s % S) * stage + shift_of(slice(g));
  };
  // Group g0 + warp's L_g, w_g and mask entry for the chunk starting at g0
  // with Kc groups, loaded a chunk ahead (see the loop's end).
  double Lk = 0.0, wk = 0.0, mk = 0.0;
  auto prefetch = [&](int g0, int Kc) {
    Lk = wk = mk = 0.0;
    if (warp < Kc) {
      const int g = g0 + warp;
      Lk = __ldg(Lg + g);
      wk = __ldg(w + g);
      if (lane < ng) mk = __ldg(fm + static_cast<long>(g) * ng + lane);
    }
  };

  int issued = S > 0 ? (total < S ? total : S) : total;
  if (warp == 0 && S > 0) {
    for (int s = lane; s < issued; s += 32) issue(s);
  }
  for (int i = t; i < m; i += kThreads) {
    c[i] = carry0[static_cast<long>(b) * n + j0 + i];
    if constexpr (kLogistic) gv[i] = __ldg(y + j0 + i) - sigmoid(c[i]);
  }
  if (beta_in_smem) {
    for (int i = t; i < Gb * ng; i += kThreads) bet[i] = beta0[boff + i];
  }
  if (t == 0) *pend_g = -1;
  __syncthreads();
  const double lam_b = lam[b];
  // The carry update: tpr threads per sample (a power of two <= 32), each
  // over every tpr-th feature of the row, summed by xor-shuffles.
  int tpr = 1;
  while (2 * tpr <= 32 && 2 * tpr * m <= kThreads && tpr < ng) tpr *= 2;
  const int upd_rows = kThreads / tpr;
  const int upd_passes = (m + upd_rows - 1) / upd_rows;
  int K = Kmax < 4 ? Kmax : 4;   // groups per chunk, adapted below
  int par = 0;                   // exchange buffer of this chunk
  int done = 0;                  // ring items the serial order has passed
  prefetch(0, K < Gl ? K : Gl);

  for (int e = 0; e < n_epochs; ++e) {
    int g0 = 0;
    while (g0 < Gl) {
      const int s0 = e * Gl + g0;
      const int Kc = K < Gl - g0 ? K : Gl - g0;
      const int W = kWarps / K;          // warps per group
      const int team = warp / W;
      const int sub = warp - team * W;
      double* xp = xpart + par * kMaxK * 32;
      const int gk = g0 + warp;
      // A. this warp's share of the CTA's slice of X_g^T gv, for every group
      // of the chunk: whether a group needs its gradient is decided in C, so
      // nothing here waits on a global load.
      if (team < Kc) {
        const double* x = tile(s0 + team);
        double acc = 0.0;
        if (lane < Lw) {
          const int step = W * Lw;
          const int rstep = W * reps;
          int row = (sub * Lw + lane) / ng;
#pragma unroll 4
          for (int i = sub * Lw + lane; i < mng; i += step, row += rstep)
            acc = fma(x[i], gv[row], acc);
        }
        for (int h = reps; h > 1;) {     // fold the lanes of one feature
          const int half = (h + 1) >> 1;
          const double o = __shfl_down_sync(kFull, acc, half * ng);
          if (lane < Lw && lane / ng + half < h) acc += o;
          h = half;
        }
        if (lane < ng) (W == 1 ? xp + team * 32 : wpart + warp * 32)[lane] = acc;
      }
      if (W > 1) __syncthreads();
      // B. warp k: its group's partial over its team's warps, in order; the
      // prox's step and thresholds (no gradient needed: off the chain).
      const bool live = Lk > 0.0;
      const bool need = warp < Kc && live && __any_sync(kFull, mk != 0.0);
      const double Ls = Lscale * Lk;
      const double step = lam_b / Ls;
      const double t1 = tau * step;
      const double t2 = (1.0 - tau) * wk * step;
      if (W > 1 && need && lane < ng) {
        double sum = 0.0;
        for (int q = 0; q < W; ++q) sum += wpart[(warp * W + q) * 32 + lane];
        xp[warp * 32 + lane] = sum;
      }
      cluster_arrive();
      // beta_g is read after the arrive, its latency under the barrier's.
      // No CTA writes a beta of this chunk before every CTA has passed the
      // next chunk's barrier (the pending write below), so no read here can
      // meet another CTA's write of the same value.
      double bold = 0.0;
      if (warp < Kc && lane < ng) bold = bet[gk * ng + lane];
      // Refill, while the cluster gathers, the stages of the items the serial
      // order passed by the end of the last chunk (every read of them is
      // behind the barriers since; chunks take at most half the ring, so the
      // items of the next chunk are always in flight).
      if (S > 0) {
        const int upto = done + S < total ? done + S : total;
        if (warp == 0) {
          for (int s = issued + lane; s < upto; s += 32) issue(s);
        }
        issued = upto > issued ? upto : issued;
      }
      cluster_wait();
      // The last chunk's changed group, written now (see above); a group of
      // this chunk that it is (a buffer of at most K groups) reads the new
      // value.
      const int pg = *pend_g;
      if (pg >= 0) {
        if (t < ng) bet[pg * ng + t] = pend_nb[t];
        if (gk == pg && lane < ng) bold = pend_nb[lane];
      }
      // C. warp k: the cluster's gradient (ranks in order), both prox steps.
      if (warp < Kc) {
        double nb = 0.0, d = 0.0;
        int changed = 0;
        if (live) {
          double gsum = 0.0;
          if (need && lane < ng) {
            double part[kMaxC];           // all C loads in flight at once
#pragma unroll
            for (int r = 0; r < kMaxC; ++r) {
              part[r] = r < C ? cluster.map_shared_rank(xp, r)[warp * 32 + lane]
                              : 0.0;
            }
#pragma unroll
            for (int r = 0; r < kMaxC; ++r) {
              if (r < C) gsum += part[r];
            }
          }
          double z = 0.0;
          if (lane < ng) {
            z = (bold + gsum / Ls) * mk;
            z = copysign(fmax(fabs(z) - t1, 0.0), z);
            d = bold;
          }
          double sq = z * z;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
          const double nrm = sqrt(sq);
          nb = fmax(1.0 - t2 / fmax(nrm, 1e-30), 0.0) * z;
          d = d - nb;                       // beta_old - beta_new
          changed = __ballot_sync(kFull, lane < ng && d != 0.0) != 0u;
        }
        cand_nb[warp * 32 + lane] = nb;
        cand_d[warp * 32 + lane] = d;
        if (lane == 0) flags[warp] = changed;
      }
      __syncthreads();
      // D. the first group of the chunk that changes, if any.
      const unsigned moved = __ballot_sync(kFull, lane < Kc && flags[lane]);
      const int ks = moved ? __ffs(moved) - 1 : -1;
      if (ks < 0) {
        if (t == 0) *pend_g = -1;
        done = s0 + Kc;
        g0 += Kc;
        K = K < Kmax ? 2 * K : K;
      } else {
        const int gs = g0 + ks;
        const double* dd = cand_d + ks * 32;
        if (t < ng) pend_nb[t] = cand_nb[ks * 32 + t];
        if (t == 0) *pend_g = gs;
        if (mng > 0) {
          const double* x = tile(s0 + ks);
          const int su = t & (tpr - 1);
          for (int pass = 0; pass < upd_passes; ++pass) {
            const int j = pass * upd_rows + t / tpr;
            double s = 0.0;
            if (j < m) {
              const double* xr = x + j * ng;
              for (int q = su; q < ng; q += tpr) s = fma(xr[q], dd[q], s);
            }
            for (int off = tpr >> 1; off > 0; off >>= 1)
              s += __shfl_xor_sync(kFull, s, off);
            if (j < m && su == 0) {
              if constexpr (kLogistic) {
                const double zj = c[j] - s;   // z += X_g (beta_new - beta_old)
                c[j] = zj;
                gv[j] = __ldg(y + j0 + j) - sigmoid(zj);
              } else {
                c[j] += s;                    // r += X_g (beta_old - beta_new)
              }
            }
          }
        }
        __syncthreads();
        done = s0 + ks + 1;
        g0 = gs + 1;
        if (ks == 0 && K > 1) K /= 2;
      }
      par ^= 1;
      // The next chunk's group inputs, in flight while this one ends.
      const int g0n = g0 < Gl ? g0 : 0;
      prefetch(g0n, K < Gl - g0n ? K : Gl - g0n);
    }
  }
  __syncthreads();
  if (*pend_g >= 0 && t < ng) bet[*pend_g * ng + t] = pend_nb[t];
  __syncthreads();
  for (int i = t; i < m; i += kThreads) carry[static_cast<long>(b) * n + j0 + i] = c[i];
  if (beta_in_smem && rank == 0) {
    for (int i = t; i < Gb * ng; i += kThreads) beta[boff + i] = bet[i];
  }
  // No CTA leaves while another may still read its exchange buffer.
  cluster_arrive();
  cluster_wait();
}

template <bool kLogistic>
int bcd_chunk_launch(const void* xt, const void* Lg, const void* w,
                     const void* fmask, const void* lam, double tau,
                     const void* y, const void* beta0, const void* carry0,
                     void* beta, void* carry, int B, int Gb, int n, int ng,
                     int n_epochs, int C, int S, int stage, int Kmax,
                     int beta_in_smem, int smem_bytes, void* stream) {
  const int carries = kLogistic ? 2 : 1;
  const Layout L(carries, (n + C - 1) / C, Gb, ng, S, stage, beta_in_smem);
  if (C < 1 || C > kMaxC || (C & (C - 1)) != 0 || S < 0 || Kmax < 1 ||
      static_cast<long>(n_epochs) * Gb + 32L * (S + 1) > 0x7fffffffL ||
      Kmax > kMaxK || (Kmax & (Kmax - 1)) != 0 || (S > 0 && S < 2 * Kmax) ||
      ng < 1 || ng > 32 || L.total != smem_bytes ||
      (reinterpret_cast<uintptr_t>(xt) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bcd_chunk_kernel<kLogistic>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const double*>(xt),
      static_cast<const double*>(Lg), static_cast<const double*>(w),
      static_cast<const double*>(fmask), static_cast<const double*>(lam), tau,
      static_cast<const double*>(y), static_cast<const double*>(beta0),
      static_cast<const double*>(carry0), static_cast<double*>(beta),
      static_cast<double*>(carry), Gb, n, ng, n_epochs, C, S, stage, Kmax,
      beta_in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C CTAs with this shared memory the card can hold at
// once (cudaOccupancyMaxActiveClusters); 0 means such a cluster cannot run.
// The kernel's attributes are as they were before the call (the launcher
// sets its own).
template <bool kLogistic>
int bcd_chunk_max_active_clusters(int C, int smem_bytes) {
  auto kernel = bcd_chunk_kernel<kLogistic>;
  ScopedQueryAttributes<decltype(kernel)> scope(kernel, smem_bytes, C);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // namespace
