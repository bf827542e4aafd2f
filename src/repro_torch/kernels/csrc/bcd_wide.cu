// Fused cyclic BCD epochs for the least-squares SGL, one lambda over a wide
// buffer, on the whole card.
//
// Replaces no TPU kernel of its own: it computes what bcd_epoch.cu computes
// (repro/kernels/bcd_epoch.py::bcd_epoch_pallas; the update is in
// bcd_epoch.cu's header) for the launches where that kernel's one cluster
// per lambda leaves the card idle: one lambda (B = 1) over a buffer of at
// least kernels/bcd_wide.py's WIDE_MIN_GROUPS slots.  The wrapper picks it
// from those shapes alone; it shares no code with bcd_chunk.cuh.
//
// Bound on this card: bytes.  An epoch reads every live group's (n, ng)
// slice of the design once (479 MB at the climate width: 0.143 ms at
// 3.35 TB/s).  The serial chain of cyclic BCD is real only for the groups
// that move: a group whose beta_g is 0 at the start of the epoch and stays
// 0 leaves the residual as it found it.  So the chain is split in two:
//
// 1. Movers, in order, on CTA 0.  M is the sorted list of live groups with
//    beta_g != 0 at the start of the epoch (kept across epochs: exits leave
//    it when the epoch ends, entrants join it when found).  CTA 0 runs the
//    exact update over M in group order from the residual r it keeps in
//    shared memory, and after each mover stores a snapshot of r in global
//    memory, marked ready with the pass's stamp (release).
// 2. Every other live group, in parallel, on CTAs 1 .. grid - 1 (the
//    workers).  Group g's gradient X_g^T r is taken against the snapshot
//    after the last mover before g: the residual the serial order gives g,
//    since the still groups between leave it unchanged.  The same two
//    soft-thresholds follow; a group whose candidate beta_g is not 0 is an
//    entrant, and the smallest one is kept with an integer atomicMin.
// 3. Commit or redo (CTA 0, once every worker has reported).  With no
//    entrant the pass equals the serial sweep.  With a first entrant g_v,
//    every update before g_v stands; the movers after it get back their
//    betas of the pass's start, r goes back to g_v's snapshot, g_v joins M,
//    and the next pass starts at g_v (its update is the first mover step).
//
// A pass covers at most `cap` movers (the snapshot banks' size); the next
// pass starts at the next mover.  Phases 1 and 2 overlap: a worker waits
// only for the snapshot its next group needs, and its producer waits for
// it, not its consumers.  CTA 0 marks snapshots ready 4 at a time (one
// fence for 4 movers: the fence's latency is off the chain), and its
// producer stops issuing movers past the smallest entrant found so far
// (their updates would be undone), so a redo costs a handshake and little
// wasted work, not the rest of the chain.  Every live group's slice is
// read and its gradient taken in every epoch; nothing is skipped on a
// bound.
//
// The design of each CTA (one per SM, a cooperative launch, so that every
// CTA is resident while others spin on its flags): a producer warp puts
// group slices into a ring of S stages with bulk copies (each stage also
// carries the group's L_g, w_g and mask row, written by the producer), and
// 8 consumer warps reduce them.  Per group the consumers sum X_g^T r in a
// fixed order: lanes over consecutive doubles (the feature of element e is
// e mod ng), shuffles over the lanes of one feature, the 8 warps' partials
// added in warp order by warp 0, which applies the prox.  A worker walks
// the groups g = start + w, start + w + (grid - 1), ... of its pass, so all
// workers move through the groups together; a worker's producer also puts
// each snapshot its groups need into one of two residual buffers (bulk
// copies after an acquire of the snapshot's ready flag), and stops issuing
// groups past the smallest entrant found so far (a smaller one cannot be
// among them).  CTA 0's producer streams the movers' slices the same way.
// A pass starts when CTA 0 publishes its header (start, stop, the movers)
// and ends when every worker has counted itself in.  Every thread of the
// launch gets each value from the same data by the same operations: no
// float atomics, and two launches give the same bits.  Inert slots (L_g <=
// 0) are never swept and keep beta_g bit for bit; the mask multiplies z as
// in bcd_epoch.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_query.cuh"

namespace {

constexpr int kWarps = 8;                        // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;        // + the producer warp
constexpr int kMaxNg = 32;
constexpr int kMeta = 64;                        // bytes before a stage's mask
constexpr int kHdr = 8;                          // header ints before the movers
constexpr int kNone = 0x7fffffff;                // no entrant
constexpr int kPassEnd = -1;                     // item kinds (Meta::g)
constexpr int kLaunchEnd = -2;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSpinCycles = 1LL << 35;     // ~20 s: a lost flag traps
constexpr int kPublish = 4;                      // snapshots marked per fence
// sint[] slots in shared memory (CTA 0's control, broadcast by barriers):
// the pass's mover count and kind, one pair per header bank (the producer
// may read pass p's after the consumers wrote pass p + 1's), the entrant,
// a mover's verdict, the scan's per-warp sums.
enum { kSK = 0, kSKind = 2, kSE = 4, kSCh = 5, kSScan = 8 };

__host__ __device__ __forceinline__ long r16(long b) { return (b + 15) & ~15L; }
__host__ __device__ __forceinline__ long r256(long b) { return (b + 255) & ~255L; }

// Shared memory of one CTA: the ring's barriers, the warps' partials, the
// control ints, the pass's movers, the producer's batch of mask rows (and
// of beta rows, CTA 0), the two residual buffers and the ring.  kernels/bcd_wide.py computes the same.
struct Smem {
  long stage, bars, part, misc, mov, fmb, rbuf, ring, total;
  __host__ __device__ Smem(int n, int ng, int S, int cap) {
    const long npad = n + (n & 1);
    stage = kMeta + 2 * r16(8L * ng) + r16(8L * (static_cast<long>(n) * ng + 2));
    bars = 0;                                    // full, empty [S]; rfull, rempty [2]
    part = r16(8L * (2 * S + 4));                // [2][kWarps][32] doubles
    misc = part + 8L * 2 * kWarps * 32;          // dvec [32] doubles, sint [64]
    mov = misc + 8L * 32 + 4L * 64;              // [cap] ints
    fmb = mov + r16(4L * cap);                   // [2][32][ng] doubles
    rbuf = fmb + 2 * r16(8L * 32 * ng);          // [2][npad] doubles
    ring = rbuf + 16L * npad;                    // [S] stages
    total = ring + S * stage;
  }
};

// The launch's scratch in global memory; [0, flags) is zeroed by the
// wrapper before the launch (stamps start at 1).
struct Scratch {
  long hdr, ready, entrant, arrived, flags, mlist, olds, snaps, total;
  __host__ __device__ Scratch(int Gb, int n, int ng, int cap) {
    const long npad = n + (n & 1);
    hdr = 0;                                     // [2][kHdr + cap] ints
    ready = hdr + 4L * 2 * (kHdr + cap);         // [2][cap + 1] ints
    entrant = ready + 4L * 2 * (cap + 1);        // [2] ints
    arrived = entrant + 8;                       // int
    flags = r256(arrived + 4);
    mlist = flags;                               // [2][Gb] ints
    olds = r256(mlist + 8L * Gb);                // [cap][ng] doubles
    snaps = r256(olds + 8L * cap * ng);          // [2][cap + 1][npad] doubles
    total = snaps + 16L * (cap + 1) * npad;
  }
};

// A stage's header, written by the producer before it arms the stage.
struct Meta {
  int g, newseg, rb, rphase, pad[4];
  double L, w;
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void trap_after(long long* start, uint32_t polls) {
  if ((polls & 1023) == 0) {
    const long long now = clock64();
    if (*start == 0) {
      *start = now;
    } else if (now - *start > kSpinCycles) {
      __trap();
    }
  }
}

// Waits for the phase of `parity` to complete (a lost stage traps).
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
    trap_after(&start, polls);
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Generic-proxy writes (a snapshot) ordered against bulk copies (async
// proxy) that read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ void spin_eq(const int* p, int want) {
  long long start = 0;
  for (uint32_t polls = 1; ld_acquire(p) != want; ++polls) {
    __nanosleep(32);
    trap_after(&start, polls);
  }
}

__device__ __forceinline__ void spin_ge(const int* p, int want) {
  long long start = 0;
  for (uint32_t polls = 1; ld_acquire(p) < want; ++polls) {
    __nanosleep(32);
    trap_after(&start, polls);
  }
}

// Barriers of the consumer warps alone (1) and of the whole CTA (2): named,
// so the producer warp may reach its own at another place in the code.
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void bar_all() {
  asm volatile("bar.sync 2, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ int shift_of(const double* a) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(a) >> 3) & 1);
}

struct Ctx {
  const double* xt;
  const double* Lg;
  const double* w;
  const double* fmask;
  const double* resid0;
  double* beta;
  double* resid;
  unsigned long long* redo;
  double lam, tau;
  int Gb, n, ng, n_epochs, S, cap, npad, mng, reps, Lw;
  long stage;
  uint64_t *full, *empty, *rfull, *rempty;
  double *part, *dvec, *fmb, *rbuf;
  int *sint, *mov;
  unsigned char* ring;
  int *hdr, *ready, *entrant, *arrived, *mlist;
  double *olds, *snaps;

  __device__ int* header(int bank) const { return hdr + bank * (kHdr + cap); }
  __device__ int* ready_of(int bank) const { return ready + bank * (cap + 1); }
  __device__ double* snap(int bank, int i) const {
    return snaps + (static_cast<long>(bank) * (cap + 1) + i) * npad;
  }
  __device__ Meta* meta(int slot) const {
    return reinterpret_cast<Meta*>(ring + slot * stage);
  }
  __device__ double* fm_of(int slot) const {
    return reinterpret_cast<double*>(ring + slot * stage + kMeta);
  }
  __device__ double* bold_of(int slot) const {     // a mover's beta_g
    return reinterpret_cast<double*>(ring + slot * stage + kMeta + r16(8L * ng));
  }
  __device__ double* slab_of(int slot) const {
    return reinterpret_cast<double*>(ring + slot * stage + kMeta + 2 * r16(8L * ng));
  }
  __device__ const double* design(int g) const {
    return xt + static_cast<long>(g) * mng;
  }
};

// Lane 0 of a producer: item `it` into its stage, for group g (or an item
// kind) with its L_g, w_g and mask row (and a mover's beta_g), and whether
// it starts a new residual buffer (which, and that buffer's phase).
__device__ void issue(const Ctx& c, int it, int g, double Lv, double wv,
                      const double* fmrow, int newseg, int rb, int rphase,
                      const double* brow = nullptr) {
  const int slot = it % c.S;
  if (it >= c.S) mbar_wait(c.empty + slot, static_cast<uint32_t>((it / c.S - 1) & 1));
  Meta* m = c.meta(slot);
  m->g = g;
  m->newseg = newseg;
  m->rb = rb;
  m->rphase = rphase;
  m->L = Lv;
  m->w = wv;
  if (g < 0) {
    mbar_arrive(c.full + slot);
    return;
  }
  double* fm = c.fm_of(slot);
  for (int f = 0; f < c.ng; ++f) fm[f] = fmrow[f];
  if (brow) {
    double* bo = c.bold_of(slot);
    for (int f = 0; f < c.ng; ++f) bo[f] = brow[f];
  }
  const double* a = c.design(g);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15);
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(a + c.mng) + 15) & ~uintptr_t(15);
  const uint32_t bytes = static_cast<uint32_t>(hi - lo);
  mbar_expect(c.full + slot, bytes);
  bulk_copy(c.slab_of(slot), reinterpret_cast<const void*>(lo), bytes, c.full + slot);
}

// This warp's share of X_g^T r over the staged slice x, into part[warp].
__device__ __forceinline__ void reduce(const Ctx& c, const double* x,
                                       const double* r, int warp, int lane,
                                       double* part) {
  double acc = 0.0;
  if (lane < c.Lw) {
    const int step = kWarps * c.Lw;
    const int rstep = kWarps * c.reps;
    int row = (warp * c.Lw + lane) / c.ng;
#pragma unroll 4
    for (int i = warp * c.Lw + lane; i < c.mng; i += step, row += rstep)
      acc = fma(x[i], r[row], acc);
  }
  for (int h = c.reps; h > 1;) {        // fold the lanes of one feature
    const int half = (h + 1) >> 1;
    const double o = __shfl_down_sync(kFull, acc, half * c.ng);
    if (lane < c.Lw && lane / c.ng + half < h) acc += o;
    h = half;
  }
  if (lane < c.ng) part[warp * 32 + lane] = acc;
}

// Warp 0: the group's gradient (the warps' partials in order) and both
// soft-thresholds from beta_g = bold; returns the new beta_g entry of this
// lane (0 past ng) and whether any entry changed.
__device__ __forceinline__ double prox(const Ctx& c, const double* part,
                                       int lane, double bold, double Lv,
                                       double wv, double mk, bool* changed) {
  double gsum = 0.0;
  if (lane < c.ng) {
#pragma unroll
    for (int q = 0; q < kWarps; ++q) gsum += part[q * 32 + lane];
  }
  const double step = c.lam / Lv;
  const double t1 = c.tau * step;
  const double t2 = (1.0 - c.tau) * wv * step;
  double z = 0.0;
  if (lane < c.ng) {
    z = (bold + gsum / Lv) * mk;
    z = copysign(fmax(fabs(z) - t1, 0.0), z);
  }
  double sq = z * z;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  const double nb = fmax(1.0 - t2 / fmax(sqrt(sq), 1e-30), 0.0) * z;
  *changed = __ballot_sync(kFull, lane < c.ng && bold - nb != 0.0) != 0u;
  return nb;
}

// The consumers' exclusive scan of one int each (in thread order), with
// the total; ws holds kWarps ints.
__device__ int excl_scan(int v, int lane, int warp, int* ws, int* total) {
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  bar_consumers();
  int before = 0, sum = 0;
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) before += ws[q];
    sum += ws[q];
  }
  bar_consumers();
  *total = sum;
  return before + x - v;
}

// CTA 0's consumers: the groups of `count` candidates (src[i], or i itself
// with src null) whose beta_g is not 0, in order, into dst; with src null
// only live groups count, and *gl gets one past the last live group.
__device__ int keep_moving(const Ctx& c, const int* src, int count, int* dst,
                           int t, int lane, int warp, int* gl) {
  int kept = 0, last = 0;
  for (int base = 0; base < count; base += 4 * kConsumers) {
    int g[4], flags = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + 4 * t + q;
      g[q] = -1;
      if (i >= count) continue;
      g[q] = src ? __ldcg(src + i) : i;
      if (!src) {
        if (!(__ldg(c.Lg + i) > 0.0)) continue;
        last = i + 1;
      }
      bool nz = false;
      for (int f = 0; f < c.ng; ++f)
        nz |= __ldcg(c.beta + static_cast<long>(g[q]) * c.ng + f) != 0.0;
      if (nz) flags |= 1 << q;
    }
    int total;
    int off = excl_scan(__popc(flags), lane, warp, c.sint + kSScan, &total);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (flags >> q & 1) dst[kept + off++] = g[q];
    kept += total;
  }
  if (gl) {
    last = __reduce_max_sync(kFull, last);
    if (lane == 0) c.sint[kSScan + warp] = last;
    bar_consumers();
    int m = 0;
    for (int q = 0; q < kWarps; ++q) m = max(m, c.sint[kSScan + q]);
    *gl = m;
    bar_consumers();
  }
  __threadfence();
  bar_consumers();
  return kept;
}

// CTA 0's producer: after each CTA barrier, the pass's movers (sint[kSK] of
// them, in mov) into the ring with their beta rows, up to the first one
// past the smallest entrant seen, then the pass's end; returns at the
// launch's end.  beta_g of a mover is last written before the barrier
// (in an earlier pass, or by a redo's restore), so it is read here.
__device__ void lead_producer(const Ctx& c, int lane) {
  int it = 0;
  double* bmb = c.fmb + 32 * c.ng;
  for (int p = 1;; ++p) {
    bar_all();
    const int bank = p & 1;
    const int kind = c.sint[kSKind + 2 * bank], k = c.sint[kSK + 2 * bank];
    if (kind) return;
    bool go = true;
    // The smallest entrant seen, read one item ahead of its use (its load
    // in flight while the item before is issued).
    int E = lane == 0 ? ld_relaxed(c.entrant + bank) : 0;
    for (int j0 = 0; go && j0 < k; j0 += 32) {
      const int i = j0 + lane;
      const bool in = i < k;
      const int g = in ? c.mov[i] : 0;
      const double Lv = in ? __ldg(c.Lg + g) : 0.0;
      const double wv = in ? __ldg(c.w + g) : 0.0;
      for (int f = 0; f < c.ng; ++f) {
        const long off = static_cast<long>(g) * c.ng + f;
        c.fmb[lane * c.ng + f] = in ? __ldg(c.fmask + off) : 0.0;
        bmb[lane * c.ng + f] = in ? __ldcg(c.beta + off) : 0.0;
      }
      __syncwarp();
      const int cnt = min(32, k - j0);
      for (int l = 0; l < cnt; ++l) {
        const int gg = __shfl_sync(kFull, g, l);
        const double Ll = __shfl_sync(kFull, Lv, l);
        const double wl = __shfl_sync(kFull, wv, l);
        if (__shfl_sync(kFull, E, 0) < gg) {
          go = false;
          break;
        }
        const int E_next = lane == 0 ? ld_relaxed(c.entrant + bank) : 0;
        if (lane == 0)
          issue(c, it, gg, Ll, wl, c.fmb + l * c.ng, 0, 0, 0, bmb + l * c.ng);
        E = E_next;
        ++it;
      }
      __syncwarp();
    }
    if (lane == 0) issue(c, it, kPassEnd, 0.0, 0.0, nullptr, 0, 0, 0);
    ++it;
    __syncwarp();
  }
}

// CTA 0's consumers: M, the passes, the mover steps, commit or redo.
__device__ void lead(const Ctx& c, int t, int lane, int warp) {
  double* r = c.rbuf;                        // the residual of the serial order
  const int nw = gridDim.x - 1;
  for (int j = t; j < c.n; j += kConsumers) r[j] = __ldg(c.resid0 + j);
  int Gl = 0;
  int mcur = 0;
  int mcount = keep_moving(c, nullptr, c.Gb, c.mlist, t, lane, warp, &Gl);
  int p = 0, it = 0;
  unsigned long long redo_total = 0;
  for (int e = 0; e < c.n_epochs; ++e) {
    if (e > 0) {                             // exits leave M
      mcount = keep_moving(c, c.mlist + mcur * c.Gb, mcount,
                           c.mlist + (mcur ^ 1) * c.Gb, t, lane, warp, nullptr);
      mcur ^= 1;
    }
    int start = 0, i0 = 0, redo_e = 0;
    while (start < Gl) {
      ++p;
      const int bank = p & 1;
      int* h = c.header(bank);
      const int* ml = c.mlist + mcur * c.Gb;
      const int k = min(c.cap, mcount - i0);
      const int stop = i0 + k < mcount ? __ldcg(ml + i0 + k) : Gl;
      for (int i = t; i < k; i += kConsumers) {
        const int g = __ldcg(ml + i0 + i);
        c.mov[i] = g;
        h[kHdr + i] = g;
      }
      double* s0 = c.snap(bank, 0);
      for (int j = t; j < c.n; j += kConsumers) s0[j] = r[j];
      if (t == 0) {
        h[1] = 0;
        h[2] = start;
        h[3] = stop;
        h[4] = k;
        c.entrant[bank] = kNone;
        c.sint[kSK + 2 * bank] = k;
        c.sint[kSKind + 2 * bank] = 0;
      }
      bar_consumers();
      if (t == 0) {
        __threadfence();
        fence_proxy_async();
        st_release(c.ready_of(bank), p);
        st_release(h, p);
      }
      bar_all();                             // the producer streams the movers
      // The movers in order, as the producer issued them: up to the pass's
      // end, or to the first one past the smallest entrant it saw (its
      // update and those after it would be undone); `done` of them.
      int done = 0;
      for (;; ++it) {
        const int slot = it % c.S;
        mbar_wait(c.full + slot, static_cast<uint32_t>((it / c.S) & 1));
        const Meta* m = c.meta(slot);
        const int g = m->g;
        if (g < 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(c.empty + slot);
          ++it;
          break;
        }
        const int i = done++;
        const double* x = c.slab_of(slot) + shift_of(c.design(g));
        double* part = c.part + (it & 1) * kWarps * 32;
        reduce(c, x, r, warp, lane, part);
        bar_consumers();
        if (warp == 0) {
          const long off = static_cast<long>(g) * c.ng + lane;
          const double bold = lane < c.ng ? c.bold_of(slot)[lane] : 0.0;
          const double mk = lane < c.ng ? c.fm_of(slot)[lane] : 0.0;
          bool changed;
          const double nb = prox(c, part, lane, bold, m->L, m->w, mk, &changed);
          if (lane < c.ng) {
            c.dvec[lane] = bold - nb;        // beta_old - beta_new
            c.olds[i * c.ng + lane] = bold;
            if (changed) c.beta[off] = nb;
          }
          if (lane == 0) c.sint[kSCh] = changed;
        }
        bar_consumers();
        const bool changed = c.sint[kSCh];
        double* si = c.snap(bank, i + 1);
        for (int j = t; j < c.n; j += kConsumers) {
          if (changed) {                     // r += X_g (beta_old - beta_new)
            const double* xr = x + j * c.ng;
            double s = 0.0;
            for (int f = 0; f < c.ng; ++f) s = fma(xr[f], c.dvec[f], s);
            r[j] += s;
          }
          si[j] = r[j];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(c.empty + slot);
        bar_consumers();
        // Every kPublish movers one fence (after the barrier it orders every
        // thread's part of those snapshots, cumulatively at gpu scope) and
        // their ready flags: the fence's latency is off the chain's path
        // for the movers between.
        if (t == 0 && done % kPublish == 0) {
          __threadfence();
          for (int q = done - kPublish; q < done; ++q)
            st_relaxed(c.ready_of(bank) + q + 1, p);
        }
      }
      if (t == 0) {
        // The snapshots not marked yet; and those past a stop, which no
        // group below the entrant reads, marked all the same so that no
        // worker waits on them.
        __threadfence();
        for (int i = done - done % kPublish; i < k; ++i)
          st_relaxed(c.ready_of(bank) + i + 1, p);
        spin_ge(c.arrived, nw * p);
        c.sint[kSE] = ld_acquire(c.entrant + bank);
      }
      bar_consumers();
      const int E = c.sint[kSE];
      if (E == kNone) {
        start = stop;
        i0 += k;
      } else {                               // redo from the first entrant
        int j = 0;
        while (j < k && c.mov[j] < E) ++j;
        for (int q = t; q < (done - j) * c.ng; q += kConsumers) {
          const int i = j + q / c.ng, f = q % c.ng;
          c.beta[static_cast<long>(c.mov[i]) * c.ng + f] = __ldcg(c.olds + i * c.ng + f);
        }
        const double* sj = c.snap(bank, j);
        for (int jj = t; jj < c.n; jj += kConsumers) r[jj] = __ldcg(sj + jj);
        const int pos = i0 + j;
        int* dst = c.mlist + (mcur ^ 1) * c.Gb;
        for (int q = t; q < mcount; q += kConsumers) dst[q + (q >= pos)] = __ldcg(ml + q);
        if (t == 0) dst[pos] = E;
        mcur ^= 1;
        ++mcount;
        i0 = pos;
        start = E;
        redo_e = 1;
        __threadfence();
      }
      bar_consumers();
    }
    redo_total += redo_e;
  }
  ++p;                                       // the launch's end
  if (t == 0) {
    int* h = c.header(p & 1);
    h[1] = 1;
    c.sint[kSKind + 2 * (p & 1)] = 1;
    __threadfence();
    st_release(h, p);
  }
  bar_all();
  for (int j = t; j < c.n; j += kConsumers) c.resid[j] = r[j];
  if (t == 0 && redo_total) atomicAdd(c.redo, redo_total);
}

// Lane 0 of a worker's producer: snapshot `seg` of the pass's bank into
// residual buffer sc & 1, once the consumers let go of that buffer's last
// load and CTA 0 has marked the snapshot ready.
__device__ void load_snapshot(const Ctx& c, int sc, int bank, int seg, int p) {
  const int b = sc & 1;
  if (sc >= 2) mbar_wait(c.rempty + b, static_cast<uint32_t>(((sc >> 1) - 1) & 1));
  spin_eq(c.ready_of(bank) + seg, p);
  fence_proxy_async();
  mbar_expect(c.rfull + b, static_cast<uint32_t>(8 * c.npad));
  bulk_copy(c.rbuf + b * c.npad, c.snap(bank, seg), 8 * c.npad, c.rfull + b);
}

// A worker's producer: per pass, its groups g = start + w + i (grid - 1)
// below stop that are live and not movers, in order, 32 candidates at a
// time, each with the snapshot of its segment; then the pass's end.
__device__ void worker_producer(const Ctx& c, int lane) {
  const int nw = gridDim.x - 1, wi = blockIdx.x - 1;
  int it = 0, sc = 0;
  for (int p = 1;; ++p) {
    const int bank = p & 1;
    const int* h = c.header(bank);
    if (lane == 0) spin_eq(h, p);
    __syncwarp();
    if (__ldcg(h + 1) != 0) {
      if (lane == 0) issue(c, it, kLaunchEnd, 0.0, 0.0, nullptr, 0, 0, 0);
      return;
    }
    const int start = __ldcg(h + 2), stop = __ldcg(h + 3), k = __ldcg(h + 4);
    for (int i = lane; i < k; i += 32) c.mov[i] = __ldcg(h + kHdr + i);
    __syncwarp();
    int last_seg = -1;
    bool go = true;
    for (long j0 = 0; go; j0 += 32) {
      const long gb = start + wi + j0 * nw;
      if (gb >= stop) break;
      int E = lane == 0 ? ld_relaxed(c.entrant + bank) : 0;
      E = __shfl_sync(kFull, E, 0);
      if (gb > E) break;
      const long gl = gb + static_cast<long>(lane) * nw;
      const bool in = gl < stop;
      const int g = in ? static_cast<int>(gl) : 0;
      const double Lv = in ? __ldg(c.Lg + g) : 0.0;
      const double wv = in ? __ldg(c.w + g) : 0.0;
      for (int f = 0; f < c.ng; ++f)
        c.fmb[lane * c.ng + f] = in ? __ldg(c.fmask + static_cast<long>(g) * c.ng + f) : 0.0;
      int lo = 0, hi = k;                      // movers before g: its segment
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c.mov[mid] < g) lo = mid + 1; else hi = mid;
      }
      const bool cand = in && Lv > 0.0 && !(lo < k && c.mov[lo] == g);
      __syncwarp();
      unsigned bits = __ballot_sync(kFull, cand);
      while (bits) {
        const int l = __ffs(bits) - 1;
        bits &= bits - 1;
        const int gg = __shfl_sync(kFull, g, l);
        const int seg = __shfl_sync(kFull, lo, l);
        const double Ll = __shfl_sync(kFull, Lv, l);
        const double wl = __shfl_sync(kFull, wv, l);
        if (gg > E) {
          go = false;
          break;
        }
        const int newseg = seg != last_seg;
        if (lane == 0)
          issue(c, it, gg, Ll, wl, c.fmb + l * c.ng, newseg, sc & 1, (sc >> 1) & 1);
        if (newseg) {
          if (lane == 0) load_snapshot(c, sc, bank, seg, p);
          ++sc;
          last_seg = seg;
        }
        ++it;
      }
      __syncwarp();                            // fmb is the next batch's
    }
    if (lane == 0) issue(c, it, kPassEnd, 0.0, 0.0, nullptr, 0, 0, 0);
    ++it;
    __syncwarp();
  }
}

// A worker's consumers: each item's gradient against its segment's
// snapshot, the prox from beta_g = 0, the smallest entrant; at each pass's
// end the worker counts itself in.
__device__ void worker_consumers(const Ctx& c, int t, int lane, int warp) {
  int cur = -1, p = 1;
  for (int it = 0;; ++it) {
    const int slot = it % c.S;
    mbar_wait(c.full + slot, static_cast<uint32_t>((it / c.S) & 1));
    const Meta* m = c.meta(slot);
    const int g = m->g;
    if (g < 0) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(c.empty + slot);
        if (cur >= 0) mbar_arrive(c.rempty + cur);
      }
      cur = -1;
      if (g == kLaunchEnd) return;
      if (t == 0) {                           // this thread made every atomicMin
        __threadfence();
        atomicAdd(c.arrived, 1);
      }
      ++p;
      continue;
    }
    if (m->newseg) {
      const int rb = m->rb;
      const uint32_t ph = static_cast<uint32_t>(m->rphase);
      __syncwarp();
      if (lane == 0 && cur >= 0) mbar_arrive(c.rempty + cur);
      cur = rb;
      mbar_wait(c.rfull + cur, ph);
    }
    double Lv = 0.0, wv = 0.0, mk = 0.0;
    if (warp == 0) {
      Lv = m->L;
      wv = m->w;
      mk = lane < c.ng ? c.fm_of(slot)[lane] : 0.0;
    }
    double* part = c.part + (it & 1) * kWarps * 32;
    reduce(c, c.slab_of(slot) + shift_of(c.design(g)), c.rbuf + cur * c.npad,
           warp, lane, part);
    __syncwarp();
    if (lane == 0) mbar_arrive(c.empty + slot);
    bar_consumers();
    if (warp == 0) {
      bool changed;
      prox(c, part, lane, 0.0, Lv, wv, mk, &changed);
      if (changed && lane == 0) atomicMin(c.entrant + (p & 1), g);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) bcd_wide_kernel(
    const double* __restrict__ xt,      // (Gb, n, ng) design
    const double* __restrict__ Lg,      // (Gb,) block Lipschitz constants
    const double* __restrict__ w,       // (Gb,) group weights
    const double* __restrict__ fmask,   // (Gb, ng) float feature mask
    const double* __restrict__ lam,     // (1,)
    double tau,
    const double* __restrict__ resid0,  // (n,) residual
    double* beta,                       // (Gb, ng) out, filled with beta0
    double* __restrict__ resid,         // (n,) out
    unsigned long long* redo,           // += epochs with a redo
    unsigned char* scratch, int Gb, int n, int ng, int n_epochs, int S,
    int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(n, ng, S, cap);
  const Scratch G(Gb, n, ng, cap);
  Ctx c;
  c.xt = xt;
  c.Lg = Lg;
  c.w = w;
  c.fmask = fmask;
  c.resid0 = resid0;
  c.beta = beta;
  c.resid = resid;
  c.redo = redo;
  c.lam = lam[0];
  c.tau = tau;
  c.Gb = Gb;
  c.n = n;
  c.ng = ng;
  c.n_epochs = n_epochs;
  c.S = S;
  c.cap = cap;
  c.npad = n + (n & 1);
  c.mng = n * ng;
  c.reps = 32 / ng;
  c.Lw = c.reps * ng;
  c.stage = L.stage;
  c.full = reinterpret_cast<uint64_t*>(smem + L.bars);
  c.empty = c.full + S;
  c.rfull = c.empty + S;
  c.rempty = c.rfull + 2;
  c.part = reinterpret_cast<double*>(smem + L.part);
  c.dvec = reinterpret_cast<double*>(smem + L.misc);
  c.sint = reinterpret_cast<int*>(smem + L.misc + 8 * 32);
  c.mov = reinterpret_cast<int*>(smem + L.mov);
  c.fmb = reinterpret_cast<double*>(smem + L.fmb);
  c.rbuf = reinterpret_cast<double*>(smem + L.rbuf);
  c.ring = smem + L.ring;
  c.hdr = reinterpret_cast<int*>(scratch + G.hdr);
  c.ready = reinterpret_cast<int*>(scratch + G.ready);
  c.entrant = reinterpret_cast<int*>(scratch + G.entrant);
  c.arrived = reinterpret_cast<int*>(scratch + G.arrived);
  c.mlist = reinterpret_cast<int*>(scratch + G.mlist);
  c.olds = reinterpret_cast<double*>(scratch + G.olds);
  c.snaps = reinterpret_cast<double*>(scratch + G.snaps);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(c.full + s, 1);
      mbar_init(c.empty + s, kWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(c.rfull + b, 1);
      mbar_init(c.rempty + b, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    if (warp == kWarps) {
      lead_producer(c, lane);
    } else {
      lead(c, t, lane, warp);
    }
  } else if (warp == kWarps) {
    worker_producer(c, lane);
  } else {
    worker_consumers(c, t, lane, warp);
  }
}

}  // namespace

extern "C" int bcd_wide_launch(const void* xt, const void* Lg, const void* w,
                               const void* fmask, const void* lam, double tau,
                               const void* resid0, void* beta, void* resid,
                               void* redo, void* scratch, int Gb, int n,
                               int ng, int n_epochs, int S, int cap, int grid,
                               int smem_bytes, void* stream) {
  const Smem L(n, ng, S, cap);
  if (ng < 1 || ng > kMaxNg || n < 1 || Gb < 1 || n_epochs < 0 || S < 2 ||
      cap < 1 || grid < 2 || L.total != smem_bytes ||
      (reinterpret_cast<uintptr_t>(xt) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 255) != 0 ||
      (reinterpret_cast<uintptr_t>(redo) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bcd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // every CTA resident at once
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, bcd_wide_kernel, static_cast<const double*>(xt),
      static_cast<const double*>(Lg), static_cast<const double*>(w),
      static_cast<const double*>(fmask), static_cast<const double*>(lam), tau,
      static_cast<const double*>(resid0), static_cast<double*>(beta),
      static_cast<double*>(resid), static_cast<unsigned long long*>(redo),
      static_cast<unsigned char*>(scratch), Gb, n, ng, n_epochs, S, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The static audit's queries (launch_query.cuh); one instance, variant 0.
extern "C" int bcd_wide_func_attributes(int variant, int* out) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return write_func_attributes(bcd_wide_kernel, out);
}

extern "C" int bcd_wide_max_active_blocks(int variant, int block, int smem) {
  if (variant != 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_blocks(bcd_wide_kernel, block, smem);
}

extern "C" const char* bcd_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
