// WavLM's gated relative-position softmax for Hopper (sm_90a), fp32: the
// attention scores (q * s) . k^T of shape (B, H, T, T), from cuBLAS, become
// the attention probabilities in place. For query i, key j of row (b, h):
//
//   x = scores[b, h, i, j] + gates[b, h, i] * table[buckets[j - i + T - 1], h]
//   p = softmax over the keys j < lengths[b] of x; keys j >= lengths[b] get 0
//
// table (NB, H) is the model's relative-position embedding, buckets the
// (2T - 1,) bucket of each distance j - i, gates the per-layer, per-query
// gate g = a (b c_h - 1) + 2 (models/wavlm.py).
//
// Replaces no TPU kernel: the JAX package has no WavLM. Unfused, PyTorch
// would gather the T x T bias, scale it by the gates, add it and the key
// mask to the scores and take the softmax: four or more passes over
// B x H x T x T floats a layer (654 MB each at B = 16, T = 799).
//
// What bounds it on an H100 SXM: each score is read once and written once,
// 8 bytes a (query, key) pair and head, 1.3 GB a layer at B = 16, H = 16,
// T = 799: 0.39 ms at 3.35 TB/s. About 10 operations a pair (a multiply, an
// add, the max, exp, the sum and a scale) are far below the fp32 peak.
//
// Design. A block is (64 query rows, one (b, h)), 8 warps, a warp a row at a
// time. The block first copies, into shared memory, the bias of each
// distance its rows can see: table[buckets[d], h] for d in the window
// [T - i_end, 2T - 1 - i0), T + 63 floats at most; the T x T bias is never
// formed. A warp reads its row once, coalesced (lane l holds keys l + 32k),
// adds the gated bias from shared memory (consecutive lanes, consecutive
// distances: no bank conflict), and keeps the row in registers when
// T <= 32 * kPer (kPer = 8, 16, 32: T <= 1024); the max and the sum go by
// shuffles; then it writes the probabilities over the scores. For T > 1024
// the row is read twice instead (an online max and sum, then the write).
// The bias is multiplied and added with separate IEEE roundings, as the
// plain version does, so the logits equal it bit for bit; exp and the sums'
// order differ from PyTorch's softmax by a few fp32 roundings.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The logit of key j: the score plus the gated bias, two roundings.
__device__ __forceinline__ float logit(const float* row, const float* bias_row, float g, int j) {
  return __fadd_rn(row[j], __fmul_rn(g, bias_row[j]));
}

// kPer > 0: a row in registers, kPer keys a lane (T <= 32 * kPer).
// kPer == 0: any T, the row read twice.
template <int kPer>
__global__ void __launch_bounds__(kThreads) wavlm_relpos_softmax_kernel(
    float* __restrict__ scores, const float* __restrict__ gates, const float* __restrict__ table,
    const int* __restrict__ buckets, const int* __restrict__ lengths, int H, int T) {
  extern __shared__ float bias[];
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.x * kRows;
  const int i_end = min(i0 + kRows, T);
  const int d_lo = T - i_end;         // the distance bucket index of (i_end - 1, 0)
  const int d_hi = 2 * T - 1 - i0;    // one past that of (i0, T - 1)
  for (int d = d_lo + threadIdx.x; d < d_hi; d += kThreads) {
    bias[d - d_lo] = table[buckets[d] * H + h];
  }
  __syncthreads();

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + warp + kWarps * r;
    if (i >= T) break;  // warp-uniform
    float* row = scores + ((size_t)bh * T + i) * T;
    const float g = gates[(size_t)bh * T + i];
    const float* bias_row = bias + (T - 1 - i - d_lo);  // bias_row[j]: distance j - i
    if constexpr (kPer > 0) {
      float v[kPer];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lane + 32 * k;
        v[k] = 0.f;
        if (j < len) {
          v[k] = logit(row, bias_row, g, j);
          m = fmaxf(m, v[k]);
        }
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lane + 32 * k;
        if (j < len) {
          v[k] = expf(v[k] - m);
          s += v[k];
        }
      }
      const float inv = 1.f / warp_sum(s);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lane + 32 * k;
        if (j < T) row[j] = j < len ? v[k] * inv : 0.f;
      }
    } else {
      float m = -INFINITY;
      float s = 0.f;
      for (int j = lane; j < len; j += 32) {
        const float x = logit(row, bias_row, g, j);
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
        } else {
          s += expf(x - m);
        }
      }
      const float mw = warp_max(m);
      s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mw));
      const float inv = 1.f / s;
      for (int j = lane; j < T; j += 32) {
        row[j] = j < len ? expf(logit(row, bias_row, g, j) - mw) * inv : 0.f;
      }
    }
  }
}

template <int kPer>
cudaError_t launch(float* scores, const float* gates, const float* table, const int* buckets,
                   const int* lengths, int B, int H, int T, cudaStream_t st) {
  const size_t smem = (size_t)(T + kRows - 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(wavlm_relpos_softmax_kernel<kPer>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared, so that the caller's next launch check does not see it
      return err;
    }
  }
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  wavlm_relpos_softmax_kernel<kPer><<<grid, kThreads, smem, st>>>(scores, gates, table, buckets,
                                                                  lengths, H, T);
  return cudaGetLastError();
}

}  // namespace

// wavlm_relpos_softmax_f32 returns the launch's cudaError_t (0 on success).
// The wrapper checks shapes and types: scores (B, H, T, T), gates (B, H, T)
// and table (NB, H) contiguous float32; buckets (2T - 1,) int32, each in
// [0, NB); lengths (B,) int32 valid keys (clamped to [0, T]; a row with none
// is written as zeros); B * H <= 65535. The scores are overwritten.
extern "C" int wavlm_relpos_softmax_f32(float* scores, const float* gates, const float* table,
                                        const int* buckets, const int* lengths, int B, int H,
                                        int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (T <= 256) {
    err = launch<8>(scores, gates, table, buckets, lengths, B, H, T, st);
  } else if (T <= 512) {
    err = launch<16>(scores, gates, table, buckets, lengths, B, H, T, st);
  } else if (T <= 1024) {
    err = launch<32>(scores, gates, table, buckets, lengths, B, H, T, st);
  } else {
    err = launch<0>(scores, gates, table, buckets, lengths, B, H, T, st);
  }
  return static_cast<int>(err);
}
