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
// (B, C) state in VMEM. Here the T steps of one (file, direction) are a chain
// of dependent min-plus steps, and a step's latency is all that counts: the
// card's bound (below) is thousands of times shorter than T such latencies.
// trans[t][i][j] depends on the inputs alone, never on the state c, so only
// the add of c[i] and the min have to wait for the step before. One block of
// 288 threads owns one (file, direction):
// - the 256 producer threads (warps 1-8) compute trans and copy local for a
//   chunk of frames ahead of the chain, with the plain version's roundings
//   (__fsub_rn, __fmul_rn), into a double buffer in shared memory. A thread
//   makes whole rows: for state j of the step's frame, trans from every state
//   i of the frame before, then local[j], so the chain's lane j reads its row
//   as float4. The state count is padded to CP = 8, 16 or 32 with
//   trans = +inf (and local = 0), so the chain's loops are compile-time and
//   the padding never wins a min. A chunk is 64, 32 or 16 frames (48 / 80 /
//   144 KB for both buffers).
// - the chain warp (warp 0) does only what depends on c: lane j (mirrored
//   over the warp) reads all of c from the step's slot in shared memory as
//   CP/4 broadcast float4, adds its row of trans (loaded a step ahead), takes
//   the min as a tree, adds local[j], stores c[j] into the next slot, and
//   __syncwarp. Each step of a chunk has its own slot, so the slots are the
//   chunk's output too: the producers copy them to device memory a chunk
//   later, and the chain issues no global store. No barrier inside a chunk;
//   one block barrier a chunk hands the chain the next buffer and the
//   producers the one it left.
// What a step costs is what its one warp queues for the shared-memory pipe
// (measured on the card, one warp alone: a dependent shuffle 26 clocks, a
// dependent shared-memory load 29, but eight independent shuffles and a tree
// min 86 and sixteen 312; the store, a __syncwarp and two float4 loads 65).
// Hence the exchange through shared memory and not by one shuffle a state
// (0.111 against 0.067 us a step at C = 7 when both were tried in this
// kernel), rows read as float4 and not as CP scalars, the reads of c ahead of
// the prefetch in program order, and the output left to the producers
// (0.067 -> 0.057 us). A chain warp of only CP live lanes was not faster.
// Both directions of K7 run in one launch (grid = 2B blocks); the reverse
// block takes frame T-1-s at step s and its cost lands at that frame, so it
// writes flip(e) directly; its trans is the same function read from the
// other side (from state i of frame t+1 to state j of frame t). A second tiny
// kernel forms K7's argmin over (c, flip(e), local), one thread per frame.
//
// Bit-exact against the plain PyTorch version. Min is exact in any order;
// the only rounding is in w_vv * |delta| and the two additions, done here in
// the plain version's order with __fsub_rn/__fmul_rn/__fadd_rn (no FMA
// contraction), so kernel and plain version agree bit for bit. Inputs are
// finite (the wrapper's contract): +inf only ever meets finite values.
//
// What bounds it on an H100 SXM. Each step is B*C^2 compare-adds on a
// (B, C) state; at the openSMILE shape (B=4, T=6485, C=7) the inputs are
// 2.2 MB (0.65 us at 3.35 TB/s) and the arithmetic is ~6.4 M operations:
// the card's bound is well under a microsecond. The kernel is bound instead
// by the latency of T dependent steps: store, __syncwarp, CP/4 loads, add,
// log2(CP) mins, add, with the prefetch of the next row queued between.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float trans_cost(float plf, float pv, float lf,
                                            float v, float w_vv, float w_same,
                                            float w_diff) {
  const bool pvo = pv > 0.0f;
  const bool vo = v > 0.0f;
  if (pvo && vo) return __fmul_rn(w_vv, fabsf(__fsub_rn(plf, lf)));
  return pvo == vo ? w_same : w_diff;
}

// min of x[0..N-1] as a tree of depth log2(N), N a power of two.
template <int N>
struct TreeMin {
  static __device__ __forceinline__ float of(const float* x) {
    return fminf(TreeMin<N / 2>::of(x), TreeMin<N / 2>::of(x + N / 2));
  }
};
template <>
struct TreeMin<1> {
  static __device__ __forceinline__ float of(const float* x) { return x[0]; }
};

// The double buffer in shared memory, by padded state count CP. A frame is
// CP rows, one per state j of the step's frame: trans[0..CP-1][j] (from each
// state i of the frame before), then local[j], padded to CP + 4 floats so that
// the 16-byte reads of eight neighbouring lanes fall into different banks.
template <int CP>
struct Ring {
  static constexpr int kFrames = CP == 8 ? 64 : CP == 16 ? 32 : 16;  // of a chunk
  static constexpr int kRow = CP + 4;
  static constexpr int kFrame = CP * kRow;
  static constexpr int kFloats = kFrames * kFrame;  // of one buffer
  static constexpr int kThreads = 288;  // the chain's warp and 256 producers
  static constexpr size_t kBytes = 2 * (size_t)kFloats * sizeof(float);
};

// Step s (1 <= s < T) ends in this frame; it comes from the one before in
// the direction's order (frame - 1 forward, frame + 1 in reverse).
__device__ __forceinline__ int frame_of(int s, int dir, int T) {
  return dir ? T - 1 - s : s;
}

// The producers' part: the rows of the `len` steps from step s0 on, for the
// `n` producer threads of which this is number `p`. A thread makes whole rows
// (one state j of one frame): its own frame's lf, v and local once, then the
// CP states of the frame before, all loads of a row in flight together.
template <int CP>
__device__ __forceinline__ void produce(
    float* buf, const float* __restrict__ lf_b, const float* __restrict__ v_b,
    const float* __restrict__ l_b, int s0, int len, int dir, int T, int C,
    float w_vv, float w_same, float w_diff, int p, int n) {
  for (int r = p; r < len * CP; r += n) {
    const int f = r / CP, j = r % CP;
    const int cur = frame_of(s0 + f, dir, T);
    const size_t at_c = (size_t)cur * C + j;
    const size_t at_p = (size_t)(dir ? cur + 1 : cur - 1) * C;
    const bool real = j < C;
    const float lf_j = real ? __ldg(lf_b + at_c) : 0.0f;
    const float v_j = real ? __ldg(v_b + at_c) : 0.0f;
    const float loc = real ? __ldg(l_b + at_c) : 0.0f;
    float tr[CP];
#pragma unroll
    for (int i = 0; i < CP; ++i) {
      tr[i] = INFINITY;
      if (real && i < C)
        tr[i] = trans_cost(__ldg(lf_b + at_p + i), __ldg(v_b + at_p + i), lf_j, v_j,
                           w_vv, w_same, w_diff);
    }
    float* row = buf + f * Ring<CP>::kFrame + j * Ring<CP>::kRow;
#pragma unroll
    for (int q = 0; q < CP / 4; ++q)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(tr[4 * q], tr[4 * q + 1], tr[4 * q + 2], tr[4 * q + 3]);
    row[CP] = loc;
  }
}

// The costs of the `len` steps from step s0 on, from the chain's slots
// (slot f + 1: after step s0 + f) to their frames of the output.
template <int CP>
__device__ __forceinline__ void store_costs(const float (*cs)[CP], float* __restrict__ o_b,
                                            int s0, int len, int dir, int T, int C, int p,
                                            int n) {
  for (int e = p; e < len * CP; e += n) {
    const int f = e / CP, j = e % CP;
    if (j < C) o_b[(size_t)frame_of(s0 + f, dir, T) * C + j] = cs[f + 1][j];
  }
}

template <int CP>
__global__ void __launch_bounds__(Ring<CP>::kThreads) viterbi_costs_kernel(
    const float* __restrict__ lf,     // (B, T, C)
    const float* __restrict__ v,      // (B, T, C)
    const float* __restrict__ local,  // (B, T, C)
    float* __restrict__ out,          // (ndir, B, T, C): c, then flip(e)
    int B, int T, int C, float w_vv, float w_same, float w_diff) {
  extern __shared__ __align__(16) float ring[];  // [2][frames][CP][CP + 4]
  // the state after each step of a chunk (slot 0: on entry), by chunk parity
  __shared__ __align__(16) float c_s[2][Ring<CP>::kFrames + 1][CP];
  constexpr int kFrames = Ring<CP>::kFrames;
  const int tid = threadIdx.x;
  const int dir = blockIdx.x / B;
  const int b = blockIdx.x - dir * B;
  const size_t base = (size_t)b * T * C;
  const float* lf_b = lf + base;
  const float* v_b = v + base;
  const float* l_b = local + base;
  float* o_b = out + (size_t)dir * B * T * C + base;
  const bool chain = tid < 32;
  const int n_prod = Ring<CP>::kThreads - 32;
  const int n_chunks = (T - 1 + kFrames - 1) / kFrames;

  // the chain's state: lane j (mirrored every CP lanes) holds c[j]
  const int j = tid & (CP - 1);
  float c = 0.0f;
  if (chain) {
    const size_t first = (size_t)(dir ? T - 1 : 0) * C + j;
    c = j < C ? l_b[first] : INFINITY;
    if (tid < C) o_b[first] = c;
  } else if (n_chunks > 0) {
    produce<CP>(ring, lf_b, v_b, l_b, 1, min(kFrames, T - 1), dir, T, C, w_vv, w_same,
                w_diff, tid - 32, n_prod);
  }
  __syncthreads();

  for (int k = 0; k < n_chunks; ++k) {
    const int s0 = 1 + k * kFrames;
    const int len = min(kFrames, T - s0);
    if (!chain) {
      // the costs of chunk k-1 out, and chunk k+1 into the buffer the chain
      // left at the last barrier
      if (k > 0) store_costs<CP>(c_s[(k - 1) & 1], o_b, s0 - kFrames, kFrames, dir, T, C,
                                 tid - 32, n_prod);
      if (k + 1 < n_chunks)
        produce<CP>(ring + ((k + 1) & 1) * Ring<CP>::kFloats, lf_b, v_b, l_b, s0 + kFrames,
                    min(kFrames, T - s0 - kFrames), dir, T, C, w_vv, w_same, w_diff,
                    tid - 32, n_prod);
    } else {
      const float* row = ring + (k & 1) * Ring<CP>::kFloats + j * Ring<CP>::kRow;
      float(*cs)[CP] = c_s[k & 1];
      // One step from the row in t_use, while the next step's row loads into
      // t_load: trans and local do not hang on c, so their reads are off the
      // chain, and they follow the reads of c in program order so that the
      // chain's own shared-memory traffic is first in the queue. The lanes
      // exchange c through shared memory: one store and CP/4 broadcast reads
      // a lane (a shuffle a state took longer), each step into its own slot,
      // so one __syncwarp a step is enough and the slots are the output.
      auto step = [&](const float4(&t_use)[CP / 4], float l_use, float4(&t_load)[CP / 4],
                      float& l_load, int f) {
        float cand[CP];
#pragma unroll
        for (int q = 0; q < CP / 4; ++q) {
          const float4 cv = reinterpret_cast<const float4*>(cs[f])[q];
          cand[4 * q] = __fadd_rn(cv.x, t_use[q].x);
          cand[4 * q + 1] = __fadd_rn(cv.y, t_use[q].y);
          cand[4 * q + 2] = __fadd_rn(cv.z, t_use[q].z);
          cand[4 * q + 3] = __fadd_rn(cv.w, t_use[q].w);
        }
        if (f + 1 < len) {
          const float* next = row + (f + 1) * Ring<CP>::kFrame;
#pragma unroll
          for (int q = 0; q < CP / 4; ++q)
            t_load[q] = reinterpret_cast<const float4*>(next)[q];
          l_load = next[CP];
        }
        c = __fadd_rn(TreeMin<CP>::of(cand), l_use);
        if (tid < CP) cs[f + 1][tid] = c;
        __syncwarp();
      };
      float4 t_even[CP / 4], t_odd[CP / 4];
      float l_even = row[CP], l_odd = 0.0f;
#pragma unroll
      for (int q = 0; q < CP / 4; ++q) {
        t_even[q] = reinterpret_cast<const float4*>(row)[q];
        t_odd[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (tid < CP) cs[0][tid] = c;
      __syncwarp();
      for (int f = 0; f < len; f += 2) {
        step(t_even, l_even, t_odd, l_odd, f);
        if (f + 1 < len) step(t_odd, l_odd, t_even, l_even, f + 1);
      }
    }
    __syncthreads();
  }
  if (n_chunks > 0) {
    const int s0 = 1 + (n_chunks - 1) * kFrames;
    store_costs<CP>(c_s[(n_chunks - 1) & 1], o_b, s0, T - s0, dir, T, C, tid,
                    Ring<CP>::kThreads);
  }
}

template <int CP>
cudaError_t launch_costs(const float* lf, const float* v, const float* local, float* out,
                         int B, int T, int C, int ndir, float w_vv, float w_same,
                         float w_diff, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(viterbi_costs_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Ring<CP>::kBytes));
  if (err != cudaSuccess) return err;
  viterbi_costs_kernel<CP><<<ndir * B, Ring<CP>::kThreads, Ring<CP>::kBytes, stream>>>(
      lf, v, local, out, B, T, C, w_vv, w_same, w_diff);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      C <= 8    ? launch_costs<8>(lf, v, local, out, B, T, C, ndir, w_vv, w_same, w_diff, s)
      : C <= 16 ? launch_costs<16>(lf, v, local, out, B, T, C, ndir, w_vv, w_same, w_diff, s)
                : launch_costs<32>(lf, v, local, out, B, T, C, ndir, w_vv, w_same, w_diff, s);
  return static_cast<int>(err);
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
