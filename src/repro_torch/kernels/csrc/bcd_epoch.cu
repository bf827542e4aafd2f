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
// gradient (its z is 0).  The kernel body is bcd_chunk.cuh, shared with the
// logistic twin (bcd_epoch_logistic.cu); this file instantiates it for the
// residual carry.
#include "bcd_chunk.cuh"

extern "C" int bcd_epoch_launch(const void* xt, const void* Lg, const void* w,
                                const void* fmask, const void* lam, double tau,
                                const void* beta0, const void* resid0,
                                void* beta, void* resid, int Gb, int n, int ng,
                                int n_epochs, int beta_in_smem, int grid,
                                int block, int smem_bytes, void* stream) {
  return bcd_chunk_launch<false>(xt, Lg, w, fmask, lam, tau, nullptr, beta0,
                                 resid0, beta, resid, Gb, n, ng, n_epochs,
                                 beta_in_smem, grid, block, smem_bytes, stream);
}

extern "C" const char* bcd_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
