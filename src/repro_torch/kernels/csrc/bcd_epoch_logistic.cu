// Fused cyclic majorized BCD epochs for the logistic SGL, B lambdas in one
// launch.
//
// Replaces: repro/kernels/bcd_epoch.py::bcd_epoch_logistic_pallas
// (_bcd_epoch_logistic_kernel).  Per group g of the Gb compacted groups, in
// order, for each lambda b (labels y in {0, 1}, linear predictor z = X beta):
//   rho    = y - sigmoid(z)
//   grad   = X_g^T rho / (L_g / 4)           (sigmoid' <= 1/4 majorizes the
//                                             block Hessian)
//   u      = S_{tau lam / (L_g / 4)}((beta_g + grad) * m_g)
//   beta_g = S^gp_{(1 - tau) w_g lam / (L_g / 4)}(u)  (unchanged if L_g <= 0)
//   z     += X_g (beta_g_new - beta_g_old)
//
// Bound on this card: the serial chain of groups, as for bcd_epoch.cu — each
// group's gradient needs the predictor the previous groups left; bytes and
// flops are far below the chain's latency.
//
// Design: bcd_epoch.cu's (one thread-block cluster per lambda, each CTA a
// slice of the samples, the design streamed into a shared-memory ring,
// consecutive groups evaluated in chunks of adaptive width against the
// current state, summed over the cluster in rank order and kept up to the
// first group that changes), instantiated from bcd_chunk.cuh with the
// predictor carry.  Each CTA's shared memory holds its slices of z and
// rho = y - sigmoid(z) (2 n / C doubles, against the residual's n / C);
// rho is recomputed only at the samples a changed group moves, by the
// thread that moves them, so no extra barrier and no extra pass.  That is
// exact: rho depends on z alone, and z changes only where a group's beta
// changes, so every group reads the same rho as the reference's fresh rho
// per group.  sigmoid is the stable two-branch form in f64.
#include "bcd_chunk.cuh"

extern "C" int bcd_epoch_logistic_launch(
    const void* xt, const void* Lg, const void* w, const void* fmask,
    const void* lam, double tau, const void* y, const void* beta0,
    const void* z0, void* beta, void* z, int B, int Gb, int n, int ng,
    int n_epochs, int C, int S, int stage, int Kmax, int beta_in_smem,
    int smem_bytes, void* stream) {
  return bcd_chunk_launch<true>(xt, Lg, w, fmask, lam, tau, y, beta0, z0, beta,
                                z, B, Gb, n, ng, n_epochs, C, S, stage, Kmax,
                                beta_in_smem, smem_bytes, stream);
}

extern "C" int bcd_epoch_logistic_max_active_clusters(int C, int smem_bytes) {
  return bcd_chunk_max_active_clusters<true>(C, smem_bytes);
}

extern "C" int bcd_epoch_logistic_func_attributes(int variant, int* out) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return write_func_attributes(bcd_chunk_kernel<true>, out);
}

extern "C" const char* bcd_epoch_logistic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
