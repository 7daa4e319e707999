// Wav2Vec2-Conformer's relative-position softmax for Hopper (sm_90a), fp32:
// the content scores S = ((q + u) / 8) . k^T of shape (B, H, T, T), from
// cuBLAS, become the attention probabilities in place. For query i, key j of
// row (b, h):
//
//   x = S[b, h, i, j] + Q[b, h, i] . P[T - 1 - i + j, h]
//   p = softmax over the keys j < lengths[b] of x; keys j >= lengths[b] get 0
//
// Q = (q + v) / 8 are the position queries, read in the (B, T, H, 64) layout
// of the query projection, and P (2T - 1, H, 64) the layer's projected
// sinusoids of the distances T - 1 ... -(T - 1) (models/conformer.py).
//
// Replaces no TPU kernel: the JAX package has no Conformer. transformers
// (Wav2Vec2ConformerSelfAttention._apply_relative_embeddings) forms the full
// (B, H, T, 2T - 1) product Q . P^T, pads it with a zero column, shifts it by
// a view, keeps T columns, adds it to S, then masks and takes the softmax:
// about ten passes over B x H x T x T-sized tensors a layer (1.31 GB for the
// product alone at B = 16, H = 16, T = 799).
//
// What bounds it on an H100 SXM: each real (query, key) pair of each head
// reads its score and writes its probability once, 8 bytes (1.31 GB a layer at
// B = 16, H = 16, T = 799: 0.39 ms at 3.35 TB/s), and takes a 64-term dot
// product, 128 operations (0.31 ms at the 67 TFLOP/s fp32 FMA rate). The two
// are close, so the design keeps the dot products on the FMA pipes and the
// scores' traffic at one read and one write.
//
// Design. A block is (32 query rows i0 .. i0 + 31, one (b, h)), 8 warps.
// Row i needs position rows T - 1 - i + j for its valid keys j < len, so the
// block needs the len + 31 rows p_lo .. p_hi of P: the position term is a
// GEMM of the block's 32 query rows (64 deep) and those rows of P, each
// product landing on key j = p - (T - 1) + i of its row.
// 1. The 32 rows of Q go into shared memory once; the rows of P stream
//    through it in stages of 128, double-buffered with cp.async (stage s + 1
//    in flight while stage s is used). A row is 68 floats apart: the float4
//    reads of 8 consecutive rows hit every bank once.
// 2. A warp owns 8 query rows x 64 position rows of a stage, a thread 8 x 2
//    products in registers: per 4 channels, 8 broadcast float4 reads of Q, two
//    float4 reads of P and 64 IEEE fp32 FMAs. Each product goes to the rows'
//    buffer in shared memory (32 x T floats, T <= 1024) at its key; keys
//    >= len are never computed.
// 3. A warp then takes a row at a time, as csrc/wavlm_relpos.cu does: it
//    reads the row's scores once, coalesced (lane l holds keys l + 32k), adds
//    the position term from shared memory (one IEEE add, as the plain version
//    does), keeps the row in registers (kPer = 8, 16, 32 keys a lane), takes
//    the max and the sum by shuffles and writes the probabilities over the
//    scores. Padded query rows are computed like the others.
// The dot products' order and exp differ from the plain version's by a few
// fp32 roundings.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                      // head size
constexpr int kRows = 32;                   // query rows a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowGroups = 4;               // warps along the rows
constexpr int kWarpRows = kRows / kRowGroups;  // 8 rows a warp
constexpr int kCols = 128;                  // position rows a stage: 2 warps x 64
constexpr int kStride = kD + 4;             // floats between rows in shared memory
constexpr int kChunks = kD / 4;             // 16-byte copies a row
constexpr int kMaxT = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

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

// Rows p0 .. p0 + kCols - 1 of head h of P into dst; rows >= p_end are zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* pos, int p0, int p_end,
                                           int H, int h) {
  for (int c = threadIdx.x; c < kCols * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int k = 4 * (c % kChunks);
    float* d = dst + r * kStride + k;
    if (p0 + r < p_end) {
      copy16(d, pos + ((size_t)(p0 + r) * H + h) * kD + k);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <int kPer>
__global__ void __launch_bounds__(kThreads) conformer_relpos_softmax_kernel(
    float* __restrict__ scores, const float* __restrict__ q, const float* __restrict__ pos,
    const int* __restrict__ lengths, int H, int T) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kRows x kStride: the block's rows of Q
  float* ps = qs + kRows * kStride;       // 2 x kCols x kStride: stages of P
  const int tp = (T + 3) & ~3;
  float* xs = ps + 2 * kCols * kStride;   // kRows x tp: the rows' position terms

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - i0);
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // 1-2. the position term of the valid keys: rows p_lo .. p_hi - 1 of P
  const int p_lo = T - i0 - rows;       // T - 1 - i for the block's last row, j = 0
  const int p_hi = T - 1 - i0 + len;    // one past T - 1 - i0 + (len - 1)
  const int stages = len > 0 ? (p_hi - p_lo + kCols - 1) / kCols : 0;
  if (stages > 0) {
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int k = 4 * (c % kChunks);
      float* d = qs + r * kStride + k;
      if (r < rows) {
        copy16(d, q + ((size_t)(b * T + i0 + r) * H + h) * kD + k);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    stage_rows(ps, pos, p_lo, p_hi, H, h);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  const int row0 = (warp % kRowGroups) * kWarpRows;  // the warp's first query row
  const int col0 = (warp / kRowGroups) * 64 + lane;  // the thread's first position row
  const float* qw = qs + row0 * kStride;
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      stage_rows(ps + ((s + 1) & 1) * kCols * kStride, pos, p_lo + (s + 1) * kCols, p_hi, H, h);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* pw = ps + (s & 1) * kCols * kStride + col0 * kStride;
    float acc[kWarpRows][2];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kD; k += 4) {
      const float4 b0 = *reinterpret_cast<const float4*>(pw + k);
      const float4 b1 = *reinterpret_cast<const float4*>(pw + 32 * kStride + k);
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qw + r * kStride + k);
        fma4(acc[r][0], a, b0);
        fma4(acc[r][1], a, b1);
      }
    }
    // product (i, p) is key j = p - (T - 1) + i of row i
    const int jc = p_lo + s * kCols + col0 - (T - 1) + i0 + row0;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = jc + r + 32 * c;
        if (row0 + r < rows && j >= 0 && j < len) xs[(row0 + r) * tp + j] = acc[r][c];
      }
    }
    __syncthreads();  // the stage's buffer is refilled next iteration; xs is complete after the last
  }

  // 3. each row's logits, softmax and probabilities, a warp a row
  for (int r = warp; r < rows; r += kWarps) {
    float* row = scores + ((size_t)bh * T + i0 + r) * T;
    const float* term = xs + r * tp;
    float v[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      v[k] = 0.f;
      if (j < len) {
        v[k] = __fadd_rn(row[j], term[j]);
        m = fmaxf(m, v[k]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      if (j < len) {
        v[k] = expf(v[k] - m);
        sum += v[k];
      }
    }
    const float inv = 1.f / warp_sum(sum);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      if (j < T) row[j] = j < len ? v[k] * inv : 0.f;
    }
  }
}

size_t smem_bytes(int T) {
  return sizeof(float) * ((size_t)(kRows + 2 * kCols) * kStride + (size_t)kRows * ((T + 3) & ~3));
}

template <int kPer>
cudaError_t launch(float* scores, const float* q, const float* pos, const int* lengths, int B,
                   int H, int T, cudaStream_t st) {
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(conformer_relpos_softmax_kernel<kPer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // cleared, so that the caller's next launch check does not see it
    return err;
  }
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  conformer_relpos_softmax_kernel<kPer><<<grid, kThreads, smem, st>>>(scores, q, pos, lengths,
                                                                      H, T);
  return cudaGetLastError();
}

}  // namespace

// conformer_relpos_softmax_f32 returns the launch's cudaError_t (0 on
// success). The wrapper checks shapes and types: scores (B, H, T, T)
// contiguous float32; q (B, T, H, 64) and pos (2T - 1, H, 64) contiguous
// float32, 16-byte aligned; lengths (B,) int32 valid keys (clamped to
// [0, T]; a row with none is written as zeros); 1 <= T <= 1024;
// B * H <= 65535. The scores are overwritten.
extern "C" int conformer_relpos_softmax_f32(float* scores, const float* q, const float* pos,
                                            const int* lengths, int B, int H, int T,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (T <= 256) {
    err = launch<8>(scores, q, pos, lengths, B, H, T, st);
  } else if (T <= 512) {
    err = launch<16>(scores, q, pos, lengths, B, H, T, st);
  } else {
    err = launch<32>(scores, q, pos, lengths, B, H, T, st);
  }
  return static_cast<int>(err);
}
