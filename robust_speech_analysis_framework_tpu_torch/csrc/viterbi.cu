// Candidate-level Viterbi path finder for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels K6 `_forward_costs` / `_kernel`
// (robust_speech_analysis_framework_tpu/ops/pallas/viterbi.py:56-131) and K7
// `viterbi_path_pallas` (:135-148). For per-frame candidate states with
// log2 frequency lf, voicing v (> 0 = voiced) and local cost, each (B, T, C):
//
//     c[0][j] = local[0][j]
//     c[t][j] = min_i( c[t-1][i] + trans[i][j] ) + local[t][j]
//     trans[i][j] = w_vv * |lf[t-1][i] - lf[t][j]|  both states voiced
//                   w_same                          same voicing
//                   w_diff                          voicing changes
//
// (K6). K7 runs the same recurrence on the time-flipped inputs, e, and picks
// per frame argmin_j c[t][j] + (flip(e)[t][j] - local[t][j]): a state on a
// globally optimal path, without backtracking (trans is symmetric in i, j).
// The weights cover both callers: openSMILE's (w_tvv, w_tuu, w_tvuv) and
// Praat's (w_same = 0, local = -strength).
//
// Design. The TPU kernel walked a sequential grid over time blocks with the
// (B, C) state in VMEM. Here one warp owns one (file, direction) for the
// whole sequence: lane j holds c[j] (C <= 32, checked by the wrapper), and
// the min over i reads c[i], lf[t-1][i], v[t-1][i] from lane i by warp
// shuffles, so a step needs no shared memory and no barrier. Both directions
// of K7 run in one launch (grid = 2B warps, one per block so each lands on
// its own SM); the reverse warp reads frame T-1-s at step s and stores its
// cost at that frame, so it writes flip(e) directly. Each step's lf, v and
// local are loaded one step ahead. A second tiny kernel forms K7's argmin
// over (c, flip(e), local), one thread per frame.
//
// Bit-exact against the plain PyTorch version. Min is exact; the only
// rounding is in w_vv * |delta| and the two additions, done here in the
// plain version's order with __fsub_rn/__fmul_rn/__fadd_rn (no FMA
// contraction), so kernel and plain version agree bit for bit.
//
// What bounds it on an H100 SXM. Each step is B*C^2 compare-adds on a
// (B, C) state; at the openSMILE shape (B=4, T=6485, C=7) the inputs are
// 2.2 MB (0.65 us at 3.35 TB/s) and the arithmetic is ~6.4 M operations:
// the card's bound is well under a microsecond. The kernel is bound instead
// by the latency of T dependent steps, each ~C*10 dependent instructions on
// one warp (about 0.4 us a step at C = 7). Variants measured slower on the
// card (PERF.md): the inputs staged through shared memory by cp.async,
// a tree min over a padded register array, and the state exchanged through
// shared memory instead of shuffles. A faster design spreads the C^2
// candidates of a step over more lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float trans_cost(float plf, float pv, float lf,
                                            float v, float w_vv, float w_same,
                                            float w_diff) {
  const bool pvo = pv > 0.0f;
  const bool vo = v > 0.0f;
  if (pvo && vo) return __fmul_rn(w_vv, fabsf(__fsub_rn(plf, lf)));
  return pvo == vo ? w_same : w_diff;
}

__global__ void __launch_bounds__(32) viterbi_costs_kernel(
    const float* __restrict__ lf,     // (B, T, C)
    const float* __restrict__ v,      // (B, T, C)
    const float* __restrict__ local,  // (B, T, C)
    float* __restrict__ out,          // (ndir, B, T, C): c, then flip(e)
    int B, int T, int C, float w_vv, float w_same, float w_diff) {
  const int lane = threadIdx.x;
  const int dir = blockIdx.x / B;
  const int b = blockIdx.x - dir * B;
  const bool on = lane < C;
  const size_t base = (size_t)b * T * C;
  const float* lf_b = lf + base;
  const float* v_b = v + base;
  const float* l_b = local + base;
  float* o = out + (size_t)dir * B * T * C + base;

  // step s reads and writes frame s (forward) or T-1-s (reverse)
  int t = dir ? T - 1 : 0;
  const int dt = dir ? -1 : 1;
  float c = on ? l_b[(size_t)t * C + lane] : 0.0f;
  float plf = on ? lf_b[(size_t)t * C + lane] : 0.0f;
  float pv = on ? v_b[(size_t)t * C + lane] : 0.0f;
  if (on) o[(size_t)t * C + lane] = c;

  float nlf = 0.0f, nv = 0.0f, nl = 0.0f;
  if (T > 1 && on) {
    const size_t at = (size_t)(t + dt) * C + lane;
    nlf = lf_b[at];
    nv = v_b[at];
    nl = l_b[at];
  }
  for (int s = 1; s < T; ++s) {
    t += dt;
    const float lf_t = nlf, v_t = nv, l_t = nl;
    if (s + 1 < T && on) {  // the next step's inputs, while this one computes
      const size_t at = (size_t)(t + dt) * C + lane;
      nlf = lf_b[at];
      nv = v_b[at];
      nl = l_b[at];
    }
    float best = INFINITY;
#pragma unroll 4
    for (int i = 0; i < C; ++i) {
      const float ci = __shfl_sync(kFull, c, i);
      const float lfi = __shfl_sync(kFull, plf, i);
      const float vi = __shfl_sync(kFull, pv, i);
      best = fminf(best, __fadd_rn(ci, trans_cost(lfi, vi, lf_t, v_t, w_vv,
                                                  w_same, w_diff)));
    }
    c = __fadd_rn(best, l_t);
    plf = lf_t;
    pv = v_t;
    if (on) o[(size_t)t * C + lane] = c;
  }
}

__global__ void viterbi_argmin_kernel(
    const float* __restrict__ costs,  // (2, B, T, C): c, flip(e)
    const float* __restrict__ local,  // (B, T, C)
    int64_t* __restrict__ path,       // (B, T)
    int BT, int C) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= BT) return;
  const float* c = costs + (size_t)n * C;
  const float* e = costs + (size_t)BT * C + (size_t)n * C;
  const float* l = local + (size_t)n * C;
  float best = INFINITY;
  int64_t arg = 0;
  for (int j = 0; j < C; ++j) {
    const float s = __fadd_rn(c[j], __fsub_rn(e[j], l[j]));
    if (s < best) {  // the first minimum, as torch.argmin
      best = s;
      arg = j;
    }
  }
  path[n] = arg;
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success). The wrapper checks shapes: 1 <= C <= 32, T >= 1,
// ndir in {1, 2}, contiguous float32 inputs.

// K6 (ndir = 1): out (1, B, T, C) = c. K7's first launch (ndir = 2):
// out (2, B, T, C) = c and flip(e).
extern "C" int viterbi_costs_f32(const float* lf, const float* v,
                                 const float* local, float* out, int B, int T,
                                 int C, int ndir, float w_vv, float w_same,
                                 float w_diff, void* stream) {
  viterbi_costs_kernel<<<ndir * B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      lf, v, local, out, B, T, C, w_vv, w_same, w_diff);
  return static_cast<int>(cudaGetLastError());
}

// K7's second launch: path (B, T) int64 from the two-direction costs.
extern "C" int viterbi_argmin_f32(const float* costs, const float* local,
                                  int64_t* path, int B, int T, int C,
                                  void* stream) {
  const int n = B * T;
  viterbi_argmin_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(costs, local,
                                                               path, n, C);
  return static_cast<int>(cudaGetLastError());
}
