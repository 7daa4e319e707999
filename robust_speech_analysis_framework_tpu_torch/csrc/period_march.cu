// openSMILE's pitch-period march (cPitchJitter) for Hopper (sm_90a).
//
// Replaces the JAX package's device march `_march_periods_device`
// (robust_speech_analysis_framework_tpu/ops/jitter.py:111-312), a vmapped
// `lax.while_loop` that XLA lowers (not a Pallas kernel). For each file (a
// row of the (B, N) waveform stack, with its (T,) frame F0), starting at
// pos = 0 while pos < n - 16, no lane break and k < p_max:
//
//   fi = min(pos / hop, nf - 1), f0 = F0[fi], voiced = f0 > 0
//   t0 = sr / max(f0, f0_min), lo = max(int(t0 (1 - srr)), 8),
//   hi = int(t0 (1 + srr)) + 1, w0 = round(t0), fits = pos + 2 hi < n
//   voiced and fits: the template x[pos, pos + w0) against every lag
//     L in [lo, hi]: corr(L) = sum x[pos + i] x[pos + L + i],
//     e(L) = sum x[pos + L + i]^2 (i < w0), e_a = sum x[pos + i]^2;
//     score(L) = corr / sqrt(max(e_a e(L), 1e-30)), or 0 when e(L) or e_a
//     is at or below 1e-6 * (the energy of the GW-sample window at pos)
//     + 1e-30; the first L of the highest score is the period: row k =
//     (pos, L, max |x| over [pos, pos + L), the winner's unguarded score),
//     k += 1, pos += L
//   voiced, not fitting: the lane ends (broken)
//   unvoiced: pos jumps to the first half-hop grid point at or past the
//     next voiced frame (pos = n - 16 when none is left), where the
//     reference's crawl of half a hop a step would land
//
// The float32 quantities (t0, lo, hi, w0) are rounded as the JAX package
// rounds them. Samples at N or beyond read as 0. A band with hi < lo gives a
// zero-length row. The lag search is the port's own: every dot product is a
// float64 sum over the float32 samples, as in the float64 numpy oracle
// `mark_periods`, where the JAX march scores lags in float32 through DFT
// correlations and re-derives only the winner.
//
// Bound. A voiced step does a few 10^4 float64 operations, so the card's
// rates bound a sub-batch at microseconds; what bounds the kernel is its
// chain of dependent steps: one cursor a file, each step's window known only
// once the step before has found its period.
//
// Design: one block a file, the whole loop on the card, one launch a
// sub-batch, no host read. Eight compute warps run the steps; a ninth, the
// row warp, keeps the device memory traffic and the rows off their chain:
//   * the waveform lives in a ring of `ring` float64 samples in shared
//     memory (8192 at 16 kHz and f0_min 40, against a window of GW = 911).
//     The row warp refills it `chunk` samples at a time, ahead of the
//     cursor, by 4-byte cp.async copies (rows of the stack are not 16-byte
//     aligned; samples at N and beyond are zero-filled by the copy) into a
//     float32 staging buffer, widens them to float64 and publishes the
//     ring's end with a release store. A voiced step reads its window from
//     shared memory and checks the ring's end against the one it last read;
//     it waits only after a jump past the ring's end, off the voiced chain.
//     F0 stays in device memory: its frame, read through L1, costs the step
//     less than a copy beside the ring did (PERF.md);
//   * beside each sample the row warp keeps the sum of squares from its
//     chunk's start (and each chunk's total), so e_a and e_tot are a few
//     loads a thread, a difference of sums within a chunk or two (the
//     rounding of sums of 1024 squares; exact zeros stay zero), with no
//     block reduction;
//   * the lag search: a compute thread takes LG consecutive lags (2-8) over
//     one contiguous slice of the template (S slices a band, a power of two,
//     within one warp), holds its window in registers as it slides, and
//     keeps LG + 1 independent sums: LG correlations and one lag's energy,
//     the others' slid from it at the slice's ends; S = 4 and LG = 2 at
//     the bands of speech (lags_a_thread). A warp adds its slices up
//     through shared memory (a slice's sums in a row of odd stride, read
//     after a warp barrier), where a butterfly of shuffles would chain
//     log2 S exchanges of 2 LG values: one warp's shuffles overlap little
//     on this card (16 independent ones take 311 clocks,
//     tools/warp_latency);
//   * one block barrier a voiced step (named, the compute warps only), after
//     the warps' argmax slots. A lane ranks its lags by sign(corr) corr^2 / e
//     (the order of the scores: e_a is common), the warp by one
//     max-reduction of a 32-bit key and a ballot, falling back to a shuffle
//     tree on a tie of keys;
//   * thread 0 queues the winner's (pos, L, corr, e, e_a) in shared memory
//     and publishes the queue with the cursor at most once a chunk; the row
//     warp takes max |x| over each period from the ring, the correlation,
//     and writes the rows while the next steps run.
// An unvoiced step searches the frames after fi for the first voiced one,
// 256 at a time, from device memory (as rare as voicing changes).
//
// Profile build (kProfile): thread 0 adds up SM clocks (clock64) by phase of
// a step into prof[b] = {march, f0 and decision, window, dots, argmax, row,
// unvoiced, voiced steps << 32 | unvoiced steps}; the timed build has no
// timer code.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCompute = 256;  // the compute warps' threads
constexpr int kWarps = kCompute / 32;
constexpr int kThreads = kCompute + 32;  // and the row warp
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLG = 8;
// a warp's slice sums: corr and e of its lags (32 LG at most), S slices,
// rows of 32 LG / S + 1
constexpr int kPart = 2 * (32 * kMaxLG + 32);
// control words: {cursor, rows published} as one 64-bit word, the ring's
// end, rows written, done
enum { kPub = 0, kReady = 2, kDone, kFin, kCtl = 8 };

struct __align__(16) Slot {  // a warp's best lag
  double key;                // sign(corr) corr^2 / e, 0 where guarded
  int idx;
  int pad;
};
struct __align__(16) Row {  // a found period, queued for the row warp
  int start;
  int len;
  double corr;
  double e;
  double ea;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_acquire64(const int* p) {
  unsigned long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];" : "=l"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void st_release64(int* p, unsigned long long v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;" ::"r"(smem_addr(p)), "l"(v) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void compute_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCompute) : "memory");
}

// the slot of ring index m in the running sums: rotated within its 32 by
// its block of 32, so that a lane writing 32 consecutive samples while its
// neighbours write theirs hits other banks
__device__ __forceinline__ int swz(int m) { return (m & ~31) | ((m + (m >> 5)) & 31); }

// (key, idx) pairs: the higher key, the lower index on a tie
__device__ __forceinline__ bool beats(double s, int i, double t, int j) {
  return s > t || (s == t && i < j);
}

// a 32-bit unsigned key in the order of the float nearest to v
__device__ __forceinline__ unsigned order_key(double v) {
  const unsigned b = __float_as_uint(__double2float_rn(v));
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

// (LG, log2 S) for a band of nl lags: S = 4 slices and the fewest lags a
// thread from 2 that keep 64 groups, fewer slices past 512 lags. On the
// H100 at the openSMILE corpus's bands (38-45 lags, templates of 70-80
// samples) 4 slices of 2 lags were the fastest split measured from 2 to 16
// slices of 1 to 8 lags (PERF.md): more threads and shorter slices lose, as
// the step's cost is not its float64 work
__device__ __forceinline__ int lags_a_thread(int nl) { return min(8, max(2, (nl + 63) >> 6)); }
__device__ __forceinline__ int slices_log2(int nl) { return nl <= 512 ? 2 : nl <= 1024 ? 1 : 0; }

// One voiced step's lag search, LG lags a thread: the slices' sums, added
// up by warp through `part` (its warp's kPart doubles), the keys against the
// threshold, the warp argmax into its slot (the winning lane's corr and e
// into `wce`), the block barrier; returns the block's winner (an index into
// the band, kNone when there is no lag) and its warp.
template <int LG, typename Mark>
__device__ __forceinline__ void lag_search(const double* __restrict__ ring, int mask, int pos,
                                           int lo, int nlag, int w0, int ls, double ea,
                                           double ethr, double* part, Slot* slots, double2* wce,
                                           int tid, Mark& mark, int& widx, int& wwarp) {
  const int lane = tid & 31, warp = tid >> 5;
  const int S = 1 << ls;
  const int groups = nlag > 0 ? (nlag + LG - 1) / LG : 0;
  const int gi = tid >> ls, sl = tid & (S - 1);
  const int per_warp = (32 >> ls) * LG;  // lags a warp's lanes cover
  const int first = warp * per_warp;     // the warp's first lag
  double best = -CUDART_INF, bc = 0.0, be = 0.0;
  int bidx = kNone;
  if (first < nlag) {  // a warp with lags
    double c[LG], E[LG];
#pragma unroll
    for (int j = 0; j < LG; ++j) c[j] = E[j] = 0.0;
    const int len = ls == 0 ? w0 : (((w0 + S - 1) >> ls) | 1);
    const int ia = sl * len;
    const int cnt = gi < groups ? min(ia + len, w0) - ia : 0;
    if (cnt > 0) {
      const int ta = pos + ia;                 // template samples
      const int va = pos + lo + gi * LG + ia;  // the first lag's window samples
      double v[LG];                            // v[(i + j) % LG] = x[va + i + j]
#pragma unroll
      for (int j = 0; j < LG - 1; ++j) v[j] = ring[(va + j) & mask];
      double e0 = 0.0;
      int i = 0;
#pragma unroll 4
      for (; i + LG <= cnt; i += LG) {
#pragma unroll
        for (int t = 0; t < LG; ++t) {
          const double a = ring[(ta + i + t) & mask];
          v[(t + LG - 1) % LG] = ring[(va + i + t + LG - 1) & mask];
#pragma unroll
          for (int j = 0; j < LG; ++j) c[j] = fma(a, v[(t + j) % LG], c[j]);
          e0 = fma(v[t % LG], v[t % LG], e0);
        }
      }
#pragma unroll
      for (int t = 0; t < LG - 1; ++t) {
        if (i + t < cnt) {
          const double a = ring[(ta + i + t) & mask];
          v[(t + LG - 1) % LG] = ring[(va + i + t + LG - 1) & mask];
#pragma unroll
          for (int j = 0; j < LG; ++j) c[j] = fma(a, v[(t + j) % LG], c[j]);
          e0 = fma(v[t % LG], v[t % LG], e0);
        }
      }
      // e of lag j + 1 over the slice: e of lag j less its first sample's
      // square plus the square of the sample after its last
      E[0] = e0;
#pragma unroll
      for (int j = 1; j < LG; ++j) {
        const double h = ring[(va + j - 1) & mask];
        const double t = ring[(va + cnt + j - 1) & mask];
        E[j] = fma(t, t, fma(-h, h, E[j - 1]));
      }
    }
    // slice s of the warp's lag m (from `first`): corr at part[s * stride +
    // m], e at part[(S + s) * stride + m]; the odd stride spreads a slice's
    // writes and a lag's reads over the banks
    const int stride = per_warp + 1;
    const int m0 = (lane >> ls) * LG;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
      part[sl * stride + m0 + j] = c[j];
      part[(S + sl) * stride + m0 + j] = E[j];
    }
    __syncwarp();
    mark(3);
    // lane o sums the slices of the warp's lags o r, ..., o r + r - 1, so
    // that lags lie in the order of lanes; its first best lag
    const int r = (per_warp + 31) / 32;
    for (int q = 0; q < r; ++q) {
      const int m = lane * r + q;
      const int l = first + m;
      if (m < per_warp && l < nlag) {
        double cs = 0.0, es = 0.0;
        for (int s = 0; s < S; ++s) {
          cs += part[s * stride + m];
          es += part[(S + s) * stride + m];
        }
        const double key = (es > ethr && ea > ethr) ? cs * fabs(cs) / es : 0.0;
        if (key > best) {
          best = key;
          bidx = l;
          bc = cs;
          be = es;
        }
      }
    }
    // the warp's best: the lowest lane at the highest key holds the first
    // best lag
    const unsigned k32 = order_key(best);
    const unsigned top = __reduce_max_sync(kFull, k32);
    const unsigned at_top = __ballot_sync(kFull, k32 == top);
    int win_lane = __ffs(at_top) - 1;
    if (__popc(at_top) > 1 && top != order_key(-CUDART_INF)) {  // the exact values decide
      double wb = k32 == top ? best : -CUDART_INF;
      int wi = k32 == top ? bidx : kNone;
      for (int o = 16; o > 0; o >>= 1) {
        const double ob = __shfl_xor_sync(kFull, wb, o);
        const int oi = __shfl_xor_sync(kFull, wi, o);
        if (beats(ob, oi, wb, wi)) {
          wb = ob;
          wi = oi;
        }
      }
      win_lane = __ffs(__ballot_sync(kFull, k32 == top && bidx == wi)) - 1;
    }
    if (lane == win_lane) {
      slots[warp] = Slot{best, bidx, 0};
      wce[warp] = make_double2(bc, be);
    }
  }
  compute_barrier();  // the warps' argmax slots are in

  Slot win = Slot{-CUDART_INF, kNone, 0};
  wwarp = 0;
  for (int w = 0; w < kWarps && w * per_warp < nlag; ++w) {
    const Slot o = slots[w];
    if (beats(o.key, o.idx, win.key, win.idx)) {
      win = o;
      wwarp = w;
    }
  }
  widx = win.idx;
}

// Sum of squares of samples [a, b) from the per-chunk running sums: `sq` at
// sample j (its ring slot swizzled) holds the squares of its chunk before
// it, `tot` a chunk's total; a, b lie in the ring, at most a few chunks apart
__device__ __forceinline__ double energy(const double* __restrict__ sq,
                                         const double* __restrict__ tot, int a, int b,
                                         int mask, int chunk_shift, int tmask) {
  const int ca = a >> chunk_shift, cb = b >> chunk_shift;
  const double la = sq[swz(a & mask)], lb = sq[swz(b & mask)];
  if (ca == cb) return lb - la;
  double e = tot[ca & tmask] - la;
  for (int c = ca + 1; c < cb; ++c) e += tot[c & tmask];
  return e + lb;
}

template <bool kProfile>
__global__ void __launch_bounds__(kThreads)
period_march_kernel(const float* __restrict__ x, const float* __restrict__ f0,
                    const int* __restrict__ ns, const int* __restrict__ nfs, int N, int T, int P,
                    float sr, int hop, int skip, float mult_lo, float mult_hi, float f0_min,
                    int GW, int RING, int CHUNK, int Q, int* __restrict__ starts, int* __restrict__ lengths,
                    float* __restrict__ amps, float* __restrict__ corrs,
                    int* __restrict__ counts, long long* __restrict__ prof) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = RING / CHUNK;
  const int stage_len = CHUNK + CHUNK / 32;  // a chunk, a float of padding a 32
  double* ring = reinterpret_cast<double*>(smem);                // [RING]
  double* sq = ring + RING;                                      // [RING], swizzled
  double* tot = sq + RING;                                       // [n_chunks]
  double* part = tot + n_chunks;                                 // [kWarps][kPart]
  Slot* slots = reinterpret_cast<Slot*>(part + kWarps * kPart);  // [2][kWarps]
  double2* wce = reinterpret_cast<double2*>(slots + 2 * kWarps);  // [2][kWarps]
  Row* queue = reinterpret_cast<Row*>(wce + 2 * kWarps);         // [Q]
  float* stage = reinterpret_cast<float*>(queue + Q);            // [2][stage_len]
  int* s_found = reinterpret_cast<int*>(stage + 2 * stage_len);  // [2][kWarps]
  int* ctl = s_found + 2 * kWarps;                               // [kCtl]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xb = x + static_cast<size_t>(b) * N;
  const float* fb = f0 + static_cast<size_t>(b) * T;
  const int n = ns[b];
  const int nf = nfs[b];
  const int mask = RING - 1;
  const int chunk_shift = __ffs(CHUNK) - 1;
  const int tmask = n_chunks - 1;
  // pos / hop as the high word of pos * ceil(2^32 / hop), then set right
  const unsigned hop_mul = static_cast<unsigned>((0xffffffffull + hop) / hop);

  if (tid < kCtl) ctl[tid] = 0;
  __syncthreads();

  if (warp < kWarps) {
    // ---- the compute warps: the march ----
    long long clk[7] = {0, 0, 0, 0, 0, 0, 0};
    long long t_mark = 0, t_start = 0, n_voiced = 0, n_unvoiced = 0;
    if constexpr (kProfile) t_start = t_mark = clock64();
    auto mark = [&](int phase) {
      if constexpr (kProfile) {
        const long long t = clock64();
        clk[phase] += t - t_mark;
        t_mark = t;
      }
    };
    // thread 0 publishes {cursor, rows queued} together: samples below the
    // cursor may be overwritten, as every row below it is published
    int pub_pos = 0, pub_k = 0, done_seen = 0;
    auto publish = [&](int at, int rows) {
      st_release64(ctl + kPub, (static_cast<unsigned long long>(rows) << 32) |
                                   static_cast<unsigned>(at));
      pub_pos = at;
      pub_k = rows;
    };
    double* my_part = part + warp * kPart;
    int pos = 0, k = 0, par = 0, search = 0, ready = 0;
    while (pos < n - 16 && k < P) {
      if (pos + GW >= ready) ready = ld_acquire(&ctl[kReady]);
      int fraw = static_cast<int>(__umulhi(static_cast<unsigned>(pos), hop_mul));
      fraw -= fraw * hop > pos;
      const int fi = min(fraw, nf - 1);
      // the ring holds the window and its running sums once its end is past
      // the window's
      const bool in_ring = pos + GW < ready;
      const float f0v = fb[fi];
      if (!(f0v > 0.0f)) {
        if constexpr (kProfile) ++n_unvoiced;
        // first voiced frame after fi, frames past nf - 1 reading nf - 1
        int found = kNone;
        for (int base = fi + 1; base < nf; base += kCompute) {
          const int f = base + tid;
          const bool v = f < nf && fb[f] > 0.0f;
          const unsigned ballot = __ballot_sync(kFull, v);
          int* slot = s_found + (search & 1) * kWarps;
          if (lane == 0) slot[warp] = ballot ? base + warp * 32 + __ffs(ballot) - 1 : kNone;
          compute_barrier();
          for (int w = 0; w < kWarps; ++w) found = min(found, slot[w]);
          ++search;
          if (found != kNone) break;
        }
        const int target = found == kNone ? n - 16 : found * hop;
        const int m = max((target - pos + skip - 1) / skip, 1);
        pos += m * skip;
        mark(6);
        continue;
      }
      if constexpr (kProfile) ++n_voiced;
      const float t0 = __fdiv_rn(sr, fmaxf(f0v, f0_min));
      const int lo = max(__float2int_rz(__fmul_rn(t0, mult_lo)), 8);
      const int hi = __float2int_rz(__fmul_rn(t0, mult_hi)) + 1;
      const int w0 = __float2int_rn(t0);
      if (!(pos + 2 * hi < n)) break;  // broken: the lane ends
      mark(1);

      if (!in_ring) {
        if (tid == 0 && pub_pos != pos) publish(pos, k);
        while (pos + GW >= (ready = ld_acquire(&ctl[kReady]))) {
        }
      }
      __syncwarp();
      mark(2);

      const double ea = energy(sq, tot, pos, pos + w0, mask, chunk_shift, tmask);
      const double ethr =
          1e-6 * energy(sq, tot, pos, pos + GW, mask, chunk_shift, tmask) + 1e-30;
      Slot* slots_p = slots + par * kWarps;
      double2* wce_p = wce + par * kWarps;
      const int nlag = hi - lo + 1;
      const int ls = slices_log2(nlag);
      int widx, wwarp;
      switch (lags_a_thread(nlag)) {
#define MARCH_LG(L)                                                                            \
  case L:                                                                                      \
    lag_search<L>(ring, mask, pos, lo, nlag, w0, ls, ea, ethr, my_part, slots_p, wce_p, tid, \
                  mark, widx, wwarp);                                                          \
    break;
        MARCH_LG(2)
        MARCH_LG(3)
        MARCH_LG(4)
        MARCH_LG(5)
        MARCH_LG(6)
        MARCH_LG(7)
        MARCH_LG(8)
#undef MARCH_LG
      }
      // no valid lag (hi < lo): the JAX march's argmax over all -inf is lag
      // 0, its row (pos, 0, 0, e_a / sqrt(max(e_a^2, 1e-30)))
      const int best_len = nlag > 0 ? lo + widx : 0;
      mark(4);

      if (tid == 0) {
        double rc, re, rea = ea;
        if (nlag > 0) {
          const double2 ce = wce_p[wwarp];
          rc = ce.x;
          re = ce.y;
        } else {  // the direct sum, as the plain version takes it
          rea = 0.0;
          for (int i = 0; i < w0; ++i) rea = fma(ring[(pos + i) & mask], ring[(pos + i) & mask], rea);
          rc = re = rea;
        }
        if (k - done_seen >= Q - 1) {
          while (k - (done_seen = ld_acquire(&ctl[kDone])) >= Q) {
          }
        }
        queue[k & (Q - 1)] = Row{pos, best_len, rc, re, rea};
        const int next = pos + best_len;
        if ((next >> chunk_shift) != (pub_pos >> chunk_shift) || k + 1 - pub_k >= Q / 2)
          publish(next, k + 1);
      }
      ++k;
      pos += best_len;
      par ^= 1;
      mark(5);
    }
    if (tid == 0) {
      publish(pos, k);
      st_release(&ctl[kFin], 1);
    }
    if constexpr (kProfile) {
      if (tid == 0) {
        long long* pr = prof + static_cast<size_t>(b) * 8;
        pr[0] = clock64() - t_start;
        for (int i = 1; i <= 6; ++i) pr[i] = clk[i];
        pr[7] = (n_voiced << 32) | n_unvoiced;
      }
    }
  } else {
    // ---- the row warp: ring refills, running sums and rows ----
    int* st = starts + static_cast<size_t>(b) * P;
    int* ln = lengths + static_cast<size_t>(b) * P;
    float* am = amps + static_cast<size_t>(b) * P;
    float* co = corrs + static_cast<size_t>(b) * P;
    const int limit = n - 16 + GW + 1;  // the windows and their sums end before this sample
    int next = 0, done = 0;
    for (;;) {
      const int fin = ld_acquire(&ctl[kFin]);
      const unsigned long long word = ld_acquire64(ctl + kPub);
      const int cur = static_cast<int>(word & 0xffffffffu);
      const int pub = static_cast<int>(word >> 32);
      bool busy = false;
      // rows published with the cursor `cur`: their samples lie below it,
      // and the refills below overwrite only samples below it
      for (; done < pub; ++done) {
        const Row r = queue[done & (Q - 1)];
        float amp = 0.0f;
        for (int i = lane; i < r.len; i += 32)
          amp = fmaxf(amp, static_cast<float>(fabs(ring[(r.start + i) & mask])));
        for (int o = 16; o > 0; o >>= 1) amp = fmaxf(amp, __shfl_xor_sync(kFull, amp, o));
        if (lane == 0) {
          st[done] = r.start;
          ln[done] = r.len;
          am[done] = amp;
          co[done] = static_cast<float>(r.corr / sqrt(fmax(r.ea * r.e, 1e-30)));
        }
        busy = true;
      }
      if (busy) {
        __syncwarp();
        if (lane == 0) st_release(&ctl[kDone], done);
      }
      if (fin) break;  // read before the word: every row is published
      // chunks from the one holding the cursor (a jump skips the rest),
      // each only once the samples its slots held lie below the cursor
      int at = max(next, cur & ~(CHUNK - 1));
      int issued = 0;
      while (issued < 2 && at + CHUNK - RING <= cur && at < limit) {
        float* sbuf = stage + issued * stage_len;
        for (int i = lane; i < CHUNK; i += 32) {
          const int s = at + i;
          copy4(sbuf + i + (i >> 5), s < N ? xb + s : xb, s < N ? 4 : 0);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        at += CHUNK;
        ++issued;
      }
      if (issued) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncwarp();
        for (int c = 0; c < issued; ++c) {
          const int from = at - (issued - c) * CHUNK;
          const float* sbuf = stage + c * stage_len;
          for (int i = lane; i < CHUNK; i += 32) ring[(from + i) & mask] = sbuf[i + (i >> 5)];
          // running sums of squares: lane l takes samples 32 l .. 32 l + 31
          // of the chunk in order, after the lanes before it
          const float* mine = sbuf + 33 * lane;
          double run = 0.0;
          for (int t = 0; t < 32; ++t) {
            const double v = mine[t];
            run = fma(v, v, run);
          }
          double incl = run;  // inclusive scan over the lanes, then shifted
          for (int o = 1; o < 32; o <<= 1) {
            const double y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          const double excl = __shfl_up_sync(kFull, incl, 1);
          run = lane == 0 ? 0.0 : excl;
          const int base = (from + 32 * lane) & mask;
          for (int t = 0; t < 32; ++t) {
            sq[swz(base + t)] = run;
            const double v = mine[t];
            run = fma(v, v, run);
          }
          // the chunk's total as its last sample's sum runs on: a silent
          // tail adds exact zeros
          const double total = __shfl_sync(kFull, run, 31);
          if (lane == 0) tot[(from >> chunk_shift) & tmask] = total;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) st_release(&ctl[kReady], at);
        next = at;
        busy = true;
      }
      if (!busy) __nanosleep(64);
    }
  }
  __syncthreads();
  const int k = static_cast<int>(ld_acquire64(ctl + kPub) >> 32);
  int* st = starts + static_cast<size_t>(b) * P;
  int* ln = lengths + static_cast<size_t>(b) * P;
  float* am = amps + static_cast<size_t>(b) * P;
  float* co = corrs + static_cast<size_t>(b) * P;
  for (int i = k + tid; i < P; i += kThreads) {
    st[i] = 0;
    ln[i] = 0;
    am[i] = 0.0f;
    co[i] = 0.0f;
  }
  if (tid == 0) counts[b] = k;
}

}  // namespace

// Shared memory of one block, as ops/cuda/jitter.py:march_smem_bytes counts
// it: the float64 ring and its running sums of squares, the chunks' totals,
// the warps' slice sums, the two parities of the argmax slots and of the
// winners' (corr, e), the row queue, two padded float32 staging chunks, the
// unvoiced search's slots and the control words.
static size_t march_smem_bytes(int ring, int chunk, int queue) {
  return sizeof(double) * (2 * ring + ring / chunk + kWarps * kPart) +
         2 * kWarps * (sizeof(Slot) + sizeof(double2)) + sizeof(Row) * queue +
         sizeof(float) * 2 * (chunk + chunk / 32) + sizeof(int) * (2 * kWarps + kCtl);
}

extern "C" int period_march_smem_bytes(int ring, int chunk, int queue) {
  return static_cast<int>(march_smem_bytes(ring, chunk, queue));
}

template <bool kProfile>
static int launch(const float* x, const float* f0, const int* ns, const int* nfs, int* starts,
                  int* lengths, float* amps, float* corrs, int* counts, long long* prof, int B,
                  int N, int T, int P, float sr, int hop, int skip, float mult_lo,
                  float mult_hi, float f0_min, int GW, int HI, int ring, int chunk, int queue,
                  void* stream) {
  // the ring, chunk and queue are indexed by masks and shifts; the ring must
  // hold a window and four chunks of lead; a band's lags must fit LG = 8
  // lags a thread
  const int lo_min = static_cast<int>(sr / f0_min * mult_lo);
  const int band = HI - (lo_min > 8 ? lo_min : 8) + 2;
  if (ring & (ring - 1) || chunk & (chunk - 1) || chunk < 32 || queue & (queue - 1) ||
      queue < 2 || ring < GW + 4 * chunk || hop < 1 || band > kMaxLG * kCompute)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = march_smem_bytes(ring, chunk, queue);
  cudaError_t err = cudaFuncSetAttribute(period_march_kernel<kProfile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  period_march_kernel<kProfile><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, f0, ns, nfs, N, T, P, sr, hop, skip, mult_lo, mult_hi, f0_min, GW, ring, chunk, queue,
      starts, lengths, amps, corrs, counts, prof);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int period_march_f32(const float* x, const float* f0, const int* ns, const int* nfs,
                                int* starts, int* lengths, float* amps, float* corrs,
                                int* counts, int B, int N, int T, int P, float sr, int hop,
                                int skip, float mult_lo, float mult_hi, float f0_min, int GW,
                                int HI, int ring, int chunk, int queue, void* stream) {
  return launch<false>(x, f0, ns, nfs, starts, lengths, amps, corrs, counts, nullptr, B, N, T,
                       P, sr, hop, skip, mult_lo, mult_hi, f0_min, GW, HI, ring, chunk, queue,
                       stream);
}

extern "C" int period_march_profile_f32(const float* x, const float* f0, const int* ns,
                                        const int* nfs, int* starts, int* lengths,
                                        float* amps, float* corrs, int* counts,
                                        long long* prof, int B, int N, int T, int P, float sr,
                                        int hop, int skip, float mult_lo, float mult_hi,
                                        float f0_min, int GW, int HI, int ring, int chunk,
                                        int queue, void* stream) {
  return launch<true>(x, f0, ns, nfs, starts, lengths, amps, corrs, counts, prof, B, N, T, P,
                      sr, hop, skip, mult_lo, mult_hi, f0_min, GW, HI, ring, chunk, queue,
                      stream);
}
