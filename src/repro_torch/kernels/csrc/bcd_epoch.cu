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
// Design (bcd_chunk.cuh has the details): one thread-block cluster of C
// CTAs per lambda (C up to 16, chosen by the wrapper from B, n and ng),
// each CTA holding a contiguous slice of the samples and its slice of the
// residual in shared memory for the whole launch; beta in shared memory when
// Gb * ng fits (else in the global output).  The TPU grid's sequential
// (epoch, group) axes become loops inside the cluster.  The chain is
// shortened where it is exact to do so: the residual changes only when a
// group's coefficients change, and most groups of a cold buffer are zero
// and stay zero.  So each step works on a chunk of K consecutive groups at
// once:
//   A. every CTA sums its slice of X_g^T r for each group of the chunk from
//      a tile that the Tensor Memory Accelerator put into a shared-memory
//      ring ahead of time (the design does not depend on the residual);
//   B/C. the per-feature partials are added over the cluster through
//      distributed shared memory in rank order (one cluster barrier per
//      chunk), and every CTA applies both soft-thresholds to the same sums,
//      getting the same candidate beta_g and the same verdict on whether it
//      differs from the old one (an exact nonzero step);
//   D.  the first group k* of the chunk that changes is the only one whose
//      result stands: groups before it did not change the residual, so
//      their gradients were exact; groups after it saw a stale residual and
//      are redone (their tiles stay in the ring).  Its beta is written and
//      each CTA applies r += X_g delta to its slice from the staged tile;
//      the next chunk starts at g0 + k* + 1 (at g0 + K when none changed).
// Every group's update is thus computed from exactly the residual the
// serial order gives it.  K adapts to what the chunks show: a chunk where
// nothing changed doubles it (up to 16, or half the ring: cold buffers of
// zeros are swept 16 groups per cluster barrier), a chunk whose first group
// changed halves it (down to all 16 warps on one group: the warm end of a
// path).  All CTAs compute the same flags, so K stays uniform over the
// cluster and the run deterministic.  Inert groups (L_g <= 0) keep beta_g
// bit for bit.  The sweep ends at the last live group, so a bucket's
// padding (inert slots at its tail) is neither fetched nor reduced.  An
// inert group before it is fetched and reduced with its chunk and skips the
// prox; a group whose feature mask is all zero skips the sum over the
// cluster (its z is 0, so no gradient is needed).
//
// The least time of one group step in this design: the CTA's slice of X_g
// (n ng 8 / C bytes) at the SM's share of HBM (3.35 TB/s / 132, ~25 GB/s:
// 0.11 us at n = 814, ng = 7, C = 16), overlapped with the ring, plus per
// chunk two CTA barriers, one cluster barrier, C reads of distributed
// shared memory and the prox's shuffles and f64 divisions, shared by the
// chunk's K groups.  On an H100 SXM (700 W) the per-chunk part is what
// counts: a chunk costs ~4-4.5 us whatever its width up to 16 groups, so a
// still group step costs ~0.3 us and a moving one ~4 us, against a byte
// bound of ~0.1 us.
// This file instantiates the body for the residual carry.
#include "bcd_chunk.cuh"

extern "C" int bcd_epoch_launch(const void* xt, const void* Lg, const void* w,
                                const void* fmask, const void* lam, double tau,
                                const void* beta0, const void* resid0,
                                void* beta, void* resid, int B, int Gb, int n,
                                int ng, int n_epochs, int C, int S, int stage,
                                int Kmax, int beta_in_smem, int smem_bytes,
                                void* stream) {
  return bcd_chunk_launch<false>(xt, Lg, w, fmask, lam, tau, nullptr, beta0,
                                 resid0, beta, resid, B, Gb, n, ng, n_epochs, C,
                                 S, stage, Kmax, beta_in_smem, smem_bytes,
                                 stream);
}

extern "C" int bcd_epoch_max_active_clusters(int C, int smem_bytes) {
  return bcd_chunk_max_active_clusters<false>(C, smem_bytes);
}

extern "C" int bcd_epoch_func_attributes(int variant, int* out) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return write_func_attributes(bcd_chunk_kernel<false>, out);
}

extern "C" const char* bcd_epoch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
