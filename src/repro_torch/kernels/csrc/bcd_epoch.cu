// Fused cyclic BCD epochs for the least-squares SGL, B lambdas in one launch.
//
// Replaces: repro/kernels/bcd_epoch.py::bcd_epoch_pallas (_bcd_epoch_kernel).
// Per group g of the Gb compacted groups, in order, for each lambda b
// (paper Sec. 6):
//   grad   = X_g^T r / L_g
//   z      = S_{tau lam / L_g}((beta_g + grad) * m_g)
//   beta_g = S^gp_{(1 - tau) w_g lam / L_g}(z)     (unchanged when L_g <= 0)
//   r     += X_g (beta_g_old - beta_g_new)
//
// Bound on this card: the serial chain of groups, not bytes.  Each group's
// gradient needs the residual the previous groups left, so per lambda the
// work is Gb * n_epochs dependent steps, each a length-n reduction, a tiny
// prox and, when beta_g changed, a length-n update.  Per epoch the kernel
// reads Gb * n * ng * 8 bytes of design, shared through L2 by the B lambdas;
// byte and flop bounds are far below the chain's latency.
//
// Design: one CTA per lambda; the residual (n doubles) lives in shared
// memory for the whole launch, and so does beta when Gb * ng fits (else it
// stays in this CTA's rows of the global output).  The TPU grid's sequential
// (epoch, group) axes become loops inside the CTA.  The chain is shortened
// where it is exact to do so: the residual changes only when a group's
// coefficients change, and most groups of a cold buffer are zero and stay
// zero.  So the CTA's warps are split into K = warps / W teams of W warps,
// and each step works on a chunk of K consecutive groups at once:
//   A1. team k takes group g0 + k: its W warps split the samples, each warp
//       sums its rows of X_g^T r (one register accumulator per feature,
//       ng <= 32, xor-shuffle sums) and writes its partial;
//   A2. the team's first warp adds the W partials, applies both
//       soft-thresholds with one lane per feature, and records the candidate
//       beta_g and whether it differs from the old one (an exact nonzero
//       step);
//   B.  the first group k* of the chunk that changes is the only one whose
//       result stands: groups before it did not change the residual, so
//       their gradients were exact; groups after it saw a stale residual and
//       are redone.  Its beta is written and all threads apply r += X_g
//       delta; the next chunk starts at g0 + k* + 1 (at g0 + K when none
//       changed).
// Every group's update is thus computed from exactly the residual the
// serial order gives it.  K adapts to what the chunks show: a chunk where
// nothing changed doubles it (up to one group per warp: cold buffers of
// zeros are swept 16 groups per barrier), a chunk whose first group changed
// halves it (down to all 16 warps on one group: the warm end of a path,
// where every group moves and the reduction's latency is what counts).  All
// threads read the same flags, so K stays uniform and the run deterministic.
// Inert groups (L_g <= 0: bucket padding) skip the reduction and keep
// beta_g bit for bit; a group whose feature mask is all zero needs no
// gradient (its z is 0).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNg = 32;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

// 512 threads: the bound keeps the register count within the SM's 65,536.
__global__ void __launch_bounds__(kMaxWarps * 32) bcd_epoch_kernel(
    const double* __restrict__ xt,      // (Gb, n, ng) compacted design
    const double* __restrict__ Lg,      // (Gb,) block Lipschitz constants
    const double* __restrict__ w,       // (Gb,) group weights
    const double* __restrict__ fmask,   // (B, Gb, ng) float feature masks
    const double* __restrict__ lam,     // (B,)
    double tau,
    const double* __restrict__ beta0,   // (B, Gb, ng) warm start
    const double* __restrict__ resid0,  // (B, n) warm start
    double* __restrict__ beta,          // (B, Gb, ng) out
    double* __restrict__ resid,         // (B, n) out
    int Gb, int n, int ng, int n_epochs, int beta_in_smem) {
  extern __shared__ double smem[];
  __shared__ int flags[kMaxWarps];
  const int nwarps = blockDim.x / 32;      // a power of two
  double* r = smem;                        // n
  double* part = r + n;                    // [nwarps][32] per-warp partials
  double* cand_nb = part + nwarps * 32;    // [nwarps][32] candidate beta_g
  double* cand_d = cand_nb + nwarps * 32;  // [nwarps][32] candidate step
  double* bsm = cand_d + nwarps * 32;      // Gb * ng when beta_in_smem

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long boff = static_cast<long>(b) * Gb * ng;
  double* bet = beta_in_smem ? bsm : beta + boff;
  const double* fm = fmask + boff;
  for (int i = t; i < n; i += blockDim.x) r[i] = resid0[static_cast<long>(b) * n + i];
  for (int i = t; i < Gb * ng; i += blockDim.x) bet[i] = beta0[boff + i];
  __syncthreads();
  const double lam_b = lam[b];
  int K = nwarps >= 4 ? 4 : nwarps;        // groups per chunk, adapted below

  for (int e = 0; e < n_epochs; ++e) {
    int g0 = 0;
    while (g0 < Gb) {
      const int W = nwarps / K;            // warps per group
      const int team = warp / W;
      const int sub = warp % W;
      const int g = g0 + team;
      bool live = false;
      double m = 0.0;
      if (g < Gb) {
        live = __ldg(Lg + g) > 0.0;   // warp-uniform; L <= 0: group inert
        if (lane < ng) m = __ldg(fm + g * ng + lane);
      }
      const bool need_grad = live && __any_sync(kFull, m != 0.0);
      // A1. this warp's share of X_g^T r.
      if (need_grad) {
        const double* Xg = xt + static_cast<long>(g) * n * ng;
        double acc[kMaxNg];
#pragma unroll
        for (int q = 0; q < kMaxNg; ++q) acc[q] = 0.0;
#pragma unroll 4
        for (int j = sub * 32 + lane; j < n; j += W * 32) {
          const double rj = r[j];
          const double* xr = Xg + static_cast<long>(j) * ng;
#pragma unroll
          for (int q = 0; q < kMaxNg; ++q) {
            if (q < ng) acc[q] = fma(__ldg(xr + q), rj, acc[q]);
          }
        }
        double mine = 0.0;
#pragma unroll
        for (int q = 0; q < kMaxNg; ++q) {
          if (q < ng) {
            double v = acc[q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
            if (lane == q) mine = v;
          }
        }
        part[warp * 32 + lane] = mine;
      }
      __syncthreads();
      // A2. the team's first warp: gradient step, both soft-thresholds.
      if (sub == 0) {
        double nb = 0.0;
        double d = 0.0;
        int changed = 0;
        if (live) {
          const double L = __ldg(Lg + g);
          const double step = lam_b / L;
          const double t1 = tau * step;
          const double t2 = (1.0 - tau) * __ldg(w + g) * step;
          double z = 0.0;
          if (lane < ng) {
            double gsum = 0.0;
            if (need_grad) {
              for (int s = 0; s < W; ++s) gsum += part[(warp + s) * 32 + lane];
            }
            const double bg = bet[g * ng + lane];
            z = (bg + gsum / L) * m;
            z = copysign(fmax(fabs(z) - t1, 0.0), z);
            d = bg;
          }
          double sq = z * z;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
          const double nrm = sqrt(sq);
          nb = fmax(1.0 - t2 / fmax(nrm, 1e-30), 0.0) * z;
          d = d - nb;                       // beta_old - beta_new
          changed = __ballot_sync(kFull, lane < ng && d != 0.0) != 0u;
        }
        cand_nb[team * 32 + lane] = nb;
        cand_d[team * 32 + lane] = d;
        if (lane == 0) flags[team] = changed;
      }
      __syncthreads();
      // B. the first group of the chunk that changes, if any.
      int ks = -1;
      for (int k = 0; k < K && g0 + k < Gb; ++k) {
        if (flags[k]) {
          ks = k;
          break;
        }
      }
      if (ks < 0) {
        g0 += K;
        K = K < nwarps ? 2 * K : K;
      } else {
        const int gs = g0 + ks;
        const double* dd = cand_d + ks * 32;
        if (t < ng) bet[gs * ng + t] = cand_nb[ks * 32 + t];
        const double* Xs = xt + static_cast<long>(gs) * n * ng;
        for (int j = t; j < n; j += blockDim.x) {
          const double* xr = Xs + static_cast<long>(j) * ng;
          double s = 0.0;
          for (int q = 0; q < ng; ++q) s = fma(__ldg(xr + q), dd[q], s);
          r[j] += s;
        }
        __syncthreads();
        g0 = gs + 1;
        if (ks == 0 && K > 1) K /= 2;
      }
    }
  }
  for (int i = t; i < n; i += blockDim.x) resid[static_cast<long>(b) * n + i] = r[i];
  if (beta_in_smem) {
    for (int i = t; i < Gb * ng; i += blockDim.x) beta[boff + i] = bet[i];
  }
}

}  // namespace

extern "C" int bcd_epoch_launch(const void* xt, const void* Lg, const void* w,
                                const void* fmask, const void* lam, double tau,
                                const void* beta0, const void* resid0,
                                void* beta, void* resid, int Gb, int n, int ng,
                                int n_epochs, int beta_in_smem, int grid,
                                int block, int smem_bytes, void* stream) {
  const int warps = block / 32;
  if (block % 32 != 0 || warps > kMaxWarps || (warps & (warps - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcd_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bcd_epoch_kernel<<<grid, block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xt), static_cast<const double*>(Lg),
      static_cast<const double*>(w), static_cast<const double*>(fmask),
      static_cast<const double*>(lam), tau, static_cast<const double*>(beta0),
      static_cast<const double*>(resid0), static_cast<double*>(beta),
      static_cast<double*>(resid), Gb, n, ng, n_epochs, beta_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bcd_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
