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
// rounds them. The lag search is the port's own: every dot product is a
// direct sum in float64 over the float32 samples, as in the float64 numpy
// oracle `mark_periods`, where the JAX march scores lags in float32
// through DFT correlations and re-derives only the winner.
//
// Design. The march is sequential through each file's cursor and nothing
// else, so one block of 256 threads owns one file and runs the whole loop:
// one launch a sub-batch, no host read. The state (pos, k, broken) lives in
// every thread's registers and is updated uniformly, so control flow is the
// same in every thread and needs no broadcast. A voiced substep:
//   1. the window x[pos, pos + GW) (GW = 911 samples at 16 kHz and f0_min
//      40) into shared memory, double-buffered by step parity so warp 0's
//      amplitude scan of the step before never meets the next load;
//   2. each lag's corr and e as S-way split dot products (S a power of two
//      near 256 / lags: thread = (lag, slice)), the slices summed by
//      xor-shuffles; e_a and the window energy as block sums beside them;
//   3. the scores and a block argmax (first index on ties);
//   4. warp 0 takes max |x| over the period and lane 0 writes the row.
// Three block barriers a voiced substep. An unvoiced substep searches the
// frames after fi for the first voiced one, 256 at a time.
//
// Bound. The work a substep does is a few 10^4 float64 operations, so the
// card's rates bound a sub-batch at tens of microseconds; what bounds the
// kernel is its latency chain: the substeps of the longest file, each a
// few barriers, shuffle trees and shared-memory round trips long.
// Simple and right comes first here; speed is for later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
period_march_kernel(const float* __restrict__ x, const float* __restrict__ f0,
                    const int* __restrict__ ns, const int* __restrict__ nfs,
                    int N, int T, int P, float sr, int hop, int skip,
                    float mult_lo, float mult_hi, float f0_min, int GW, int HI,
                    int* __restrict__ starts, int* __restrict__ lengths,
                    float* __restrict__ amps, float* __restrict__ corrs,
                    int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_corr = reinterpret_cast<double*>(smem);  // [HI]
  double* s_e = s_corr + HI;                         // [HI]
  double* s_red = s_e + HI;                          // [2 * kWarps]: e_a, e_tot
  double* s_best = s_red + 2 * kWarps;               // [kWarps] scores
  int* s_bidx = reinterpret_cast<int*>(s_best + kWarps);  // [kWarps]
  int* s_found = s_bidx + kWarps;                    // [2 * kWarps]
  float* s_win = reinterpret_cast<float*>(s_found + 2 * kWarps);  // [2 * GW]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xb = x + static_cast<size_t>(b) * N;
  const float* fb = f0 + static_cast<size_t>(b) * T;
  int* st = starts + static_cast<size_t>(b) * P;
  int* ln = lengths + static_cast<size_t>(b) * P;
  float* am = amps + static_cast<size_t>(b) * P;
  float* co = corrs + static_cast<size_t>(b) * P;
  const int n = ns[b];
  const int nf = nfs[b];

  int pos = 0, k = 0, parity = 0, search = 0;
  while (pos < n - 16 && k < P) {
    const int fi = min(pos / hop, nf - 1);
    const float f0v = fb[fi];
    if (!(f0v > 0.0f)) {
      // first voiced frame after fi, frames past nf - 1 reading nf - 1
      int found = kNone;
      for (int base = fi + 1; base < nf; base += kThreads) {
        const int f = base + tid;
        const bool v = f < nf && fb[f] > 0.0f;
        const unsigned ballot = __ballot_sync(0xffffffffu, v);
        int* slot = s_found + (search & 1) * kWarps;
        if (lane == 0) slot[warp] = ballot ? base + warp * 32 + __ffs(ballot) - 1 : kNone;
        __syncthreads();
        for (int w = 0; w < kWarps; ++w) found = min(found, slot[w]);
        ++search;
        if (found != kNone) break;
      }
      const int target = found == kNone ? n - 16 : found * hop;
      const int m = max((target - pos + skip - 1) / skip, 1);
      pos += m * skip;
      continue;
    }
    const float t0 = __fdiv_rn(sr, fmaxf(f0v, f0_min));
    const int lo = max(__float2int_rz(__fmul_rn(t0, mult_lo)), 8);
    const int hi = __float2int_rz(__fmul_rn(t0, mult_hi)) + 1;
    const int w0 = __float2int_rn(t0);
    if (!(pos + 2 * hi < n)) break;  // broken: the lane ends

    // 1. the window
    float* g = s_win + parity * GW;
    for (int i = tid; i < GW; i += kThreads) g[i] = pos + i < N ? xb[pos + i] : 0.0f;
    __syncthreads();

    // 2. lag dots (S-way split) and the two energies
    const int nlag = hi - lo + 1;
    double ea = 0.0, etot = 0.0;
    for (int i = tid; i < GW; i += kThreads) {
      const double v = g[i];
      etot += v * v;
      if (i < w0) ea += v * v;
    }
    ea = warp_sum(ea);
    etot = warp_sum(etot);
    if (lane == 0) {
      s_red[warp] = ea;
      s_red[kWarps + warp] = etot;
    }
    if (nlag > 0) {
      int S = 1;
      while (S < 32 && 2 * S * nlag <= kThreads) S <<= 1;
      const int work = nlag * S;
      for (int base = 0; base < work; base += kThreads) {
        const int idx = base + tid;
        const int l = idx / S;
        const int s = idx % S;
        double c = 0.0, e = 0.0;
        if (idx < work) {
          const float* gl = g + lo + l;
          for (int i = s; i < w0; i += S) {
            const double a = g[i];
            const double v = gl[i];
            c += a * v;
            e += v * v;
          }
        }
        for (int o = S >> 1; o > 0; o >>= 1) {
          c += __shfl_xor_sync(0xffffffffu, c, o);
          e += __shfl_xor_sync(0xffffffffu, e, o);
        }
        if (idx < work && s == 0) {
          s_corr[l] = c;
          s_e[l] = e;
        }
      }
    }
    __syncthreads();

    // 3. scores and the block argmax, first index on ties
    ea = 0.0;
    etot = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      ea += s_red[w];
      etot += s_red[kWarps + w];
    }
    const double ethr = 1e-6 * etot + 1e-30;
    double best = -CUDART_INF;
    int bidx = kNone;
    for (int l = tid; l < nlag; l += kThreads) {
      const double e = s_e[l];
      const double sc = (e > ethr && ea > ethr) ? s_corr[l] / sqrt(fmax(ea * e, 1e-30)) : 0.0;
      if (sc > best) {
        best = sc;
        bidx = l;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const double ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      if (ob > best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    if (lane == 0) {
      s_best[warp] = best;
      s_bidx[warp] = bidx;
    }
    __syncthreads();
    best = -CUDART_INF;
    bidx = kNone;
    for (int w = 0; w < kWarps; ++w) {
      if (s_best[w] > best || (s_best[w] == best && s_bidx[w] < bidx)) {
        best = s_best[w];
        bidx = s_bidx[w];
      }
    }
    // no valid lag (hi < lo): the JAX march's argmax over all -inf is lag 0
    const int best_len = nlag > 0 ? lo + bidx : 0;

    // 4. the row: warp 0 scans the period's peak, lane 0 writes
    if (warp == 0) {
      float amp = 0.0f;
      for (int i = lane; i < best_len; i += 32) amp = fmaxf(amp, fabsf(g[i]));
      for (int o = 16; o > 0; o >>= 1) amp = fmaxf(amp, __shfl_xor_sync(0xffffffffu, amp, o));
      if (lane == 0) {
        const double c = nlag > 0 ? s_corr[bidx] : ea;
        const double e = nlag > 0 ? s_e[bidx] : ea;
        st[k] = pos;
        ln[k] = best_len;
        am[k] = amp;
        co[k] = static_cast<float>(c / sqrt(fmax(ea * e, 1e-30)));
      }
    }
    ++k;
    pos += best_len;
    parity ^= 1;
  }
  for (int i = k + tid; i < P; i += kThreads) {
    st[i] = 0;
    ln[i] = 0;
    am[i] = 0.0f;
    co[i] = 0.0f;
  }
  if (tid == 0) counts[b] = k;
}

}  // namespace

// Shared memory of one block: the per-lag sums, the reduction slots and the
// double-buffered window.
static size_t march_smem_bytes(int GW, int HI) {
  return sizeof(double) * (2 * HI + 3 * kWarps) + sizeof(int) * 3 * kWarps +
         sizeof(float) * 2 * GW;
}

extern "C" int period_march_smem_bytes(int GW, int HI) {
  return static_cast<int>(march_smem_bytes(GW, HI));
}

extern "C" int period_march_f32(const float* x, const float* f0, const int* ns,
                                const int* nfs, int* starts, int* lengths,
                                float* amps, float* corrs, int* counts, int B,
                                int N, int T, int P, float sr, int hop,
                                int skip, float mult_lo, float mult_hi,
                                float f0_min, int GW, int HI, void* stream) {
  const size_t smem = march_smem_bytes(GW, HI);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        period_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  period_march_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, f0, ns, nfs, N, T, P, sr, hop, skip, mult_lo, mult_hi, f0_min, GW, HI,
      starts, lengths, amps, corrs, counts);
  return static_cast<int>(cudaGetLastError());
}
