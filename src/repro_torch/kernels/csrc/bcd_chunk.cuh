// Shared body of the fused cyclic BCD epoch kernels: bcd_epoch.cu (least
// squares) and bcd_epoch_logistic.cu (logistic loss) each instantiate it
// once.  One CTA per lambda, the chunked evaluation that bcd_epoch.cu's
// header describes.  The template flag selects what the CTA carries in
// shared memory and how a changed group moves it:
//   kLogistic = false: the residual r (n doubles); the gradient reads r, the
//     step is on L_g, and a changed group moves r by X_g (beta_old - beta_new);
//   kLogistic = true: the linear predictor z and rho = y - sigmoid(z)
//     (2n doubles); the gradient reads rho, the step is on the majorization
//     bound L_g / 4, and a changed group moves z by X_g (beta_new - beta_old),
//     after which the thread that moved z[j] recomputes rho[j].  rho is a
//     function of z alone and z changes only where a group's beta changes, so
//     every group still reads the fresh rho of the serial order.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNg = 32;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

// The logistic function in f64, in the two-branch form that never overflows.
__device__ __forceinline__ double sigmoid(double v) {
  if (v >= 0.0) return 1.0 / (1.0 + exp(-v));
  const double e = exp(v);
  return e / (1.0 + e);
}

// 512 threads: the bound keeps the register count within the SM's 65,536.
template <bool kLogistic>
__global__ void __launch_bounds__(kMaxWarps * 32) bcd_chunk_kernel(
    const double* __restrict__ xt,      // (Gb, n, ng) compacted design
    const double* __restrict__ Lg,      // (Gb,) block Lipschitz constants
    const double* __restrict__ w,       // (Gb,) group weights
    const double* __restrict__ fmask,   // (B, Gb, ng) float feature masks
    const double* __restrict__ lam,     // (B,)
    double tau,
    const double* __restrict__ y,       // (n,) labels (logistic only)
    const double* __restrict__ beta0,   // (B, Gb, ng) warm start
    const double* __restrict__ carry0,  // (B, n) residual or predictor
    double* __restrict__ beta,          // (B, Gb, ng) out
    double* __restrict__ carry,         // (B, n) out
    int Gb, int n, int ng, int n_epochs, int beta_in_smem) {
  extern __shared__ double smem[];
  __shared__ int flags[kMaxWarps];
  const int nwarps = blockDim.x / 32;      // a power of two
  double* c = smem;                        // n: residual or predictor
  double* gv = kLogistic ? c + n : c;      // n: the vector gradients read
  double* part = gv + n;                   // [nwarps][32] per-warp partials
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
  const double Lscale = kLogistic ? 0.25 : 1.0;  // nu of the loss
  for (int i = t; i < n; i += blockDim.x) {
    c[i] = carry0[static_cast<long>(b) * n + i];
    if constexpr (kLogistic) gv[i] = __ldg(y + i) - sigmoid(c[i]);
  }
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
      // A1. this warp's share of X_g^T gv.
      if (need_grad) {
        const double* Xg = xt + static_cast<long>(g) * n * ng;
        double acc[kMaxNg];
#pragma unroll
        for (int q = 0; q < kMaxNg; ++q) acc[q] = 0.0;
#pragma unroll 4
        for (int j = sub * 32 + lane; j < n; j += W * 32) {
          const double rj = gv[j];
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
          const double L = Lscale * __ldg(Lg + g);
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
          if constexpr (kLogistic) {
            const double zj = c[j] - s;     // z += X_g (beta_new - beta_old)
            c[j] = zj;
            gv[j] = __ldg(y + j) - sigmoid(zj);
          } else {
            c[j] += s;                      // r += X_g (beta_old - beta_new)
          }
        }
        __syncthreads();
        g0 = gs + 1;
        if (ks == 0 && K > 1) K /= 2;
      }
    }
  }
  for (int i = t; i < n; i += blockDim.x) carry[static_cast<long>(b) * n + i] = c[i];
  if (beta_in_smem) {
    for (int i = t; i < Gb * ng; i += blockDim.x) beta[boff + i] = bet[i];
  }
}

template <bool kLogistic>
int bcd_chunk_launch(const void* xt, const void* Lg, const void* w,
                     const void* fmask, const void* lam, double tau,
                     const void* y, const void* beta0, const void* carry0,
                     void* beta, void* carry, int Gb, int n, int ng,
                     int n_epochs, int beta_in_smem, int grid, int block,
                     int smem_bytes, void* stream) {
  const int warps = block / 32;
  if (block % 32 != 0 || warps > kMaxWarps || (warps & (warps - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcd_chunk_kernel<kLogistic>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bcd_chunk_kernel<kLogistic>
      <<<grid, block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const double*>(xt), static_cast<const double*>(Lg),
          static_cast<const double*>(w), static_cast<const double*>(fmask),
          static_cast<const double*>(lam), tau, static_cast<const double*>(y),
          static_cast<const double*>(beta0),
          static_cast<const double*>(carry0), static_cast<double*>(beta),
          static_cast<double*>(carry), Gb, n, ng, n_epochs, beta_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
