// Wav2Vec2's positional conv embedding for Hopper (sm_90a), fp32: the grouped
// conv over the hidden states (C channels in G groups of CG, K taps, K / 2
// frames of zero padding on each side), its bias and the exact (erf) GELU,
// read from and written to the (B, T, C) layout the encoder keeps:
//
//   y[b, t, g CG + o] = gelu(bias[g CG + o]
//                            + sum_{k < K, i < CG} w[g CG + o, i, k] x[b, t + k - K / 2, g CG + i])
//
// with x zero outside [0, T). An even K gives PyTorch's conv one frame more
// than T; that frame is never computed. WavLM reuses the same module.
//
// Replaces no TPU kernel: the JAX package leaves the positional conv to XLA
// (robust_speech_analysis_framework_tpu/models/wav2vec2.py, its grouped
// nn.Conv). On the card cuDNN ran it as 16 concurrent implicit_convolve_sgemm
// launches, one a group: 2.40 ms for 768 channels (16 x 249 frames, 15.7
// TFLOP/s) and 9.66 ms for 1024 (16 x 799, 22 TFLOP/s), then a GELU pass.
//
// What bounds it on an H100 SXM: every tap of every frame, 2 K CG operations
// an output: 37.6 GFLOP at B = 16, T = 249, C = 768, G = 16 (0.56 ms at the
// 67 TFLOP/s fp32 FMA rate) and 214.5 GFLOP at B = 16, T = 799, C = 1024
// (3.2 ms). The bytes are few: x 12 MB / 52 MB, the weights 18.9 MB / 33.5 MB
// (both fit the 50 MB L2). It is compute-bound, so the design feeds the FMA
// pipes and spends few instructions on anything else.
//
// Design. A block is (a tile of TM output frames, group g, row b), TM threads;
// a thread holds 8 frames x CG / 8 output channels in registers (an SGEMM
// register tile; CG = 48: 48 sums, CG = 64: 64). Per block:
// 1. The tile's input window, frames t0 - K / 2 .. t0 + TM + K / 2, CG
//    channels, goes once into shared memory channel-major (a channel's frames
//    contiguous), zero outside [0, T).
// 2. The group's weights, laid out by the wrapper as (G, Kp, CG in, CG out)
//    with K padded by zero taps to Kp, a multiple of 4, stream through shared
//    memory in stages of 4 taps (4 CG^2 floats, contiguous), double-buffered
//    with cp.async: stage s + 1 is in flight while stage s is used.
// 3. For each input channel i of a stage, a thread reads the 11 window values
//    its 8 frames see over the stage's 4 taps (three float4 reads: the window
//    slides by one frame a tap, so a tap costs no read of x) and, per tap,
//    its CG / 8 weights (float4 / float2 reads, 8 threads a 128-byte row: no
//    bank conflict), then 8 x CG / 8 IEEE fp32 FMAs. A warp is 4 frame groups
//    x 8 channel groups, so each read is broadcast to 4 or 8 threads.
// 4. Epilogue: bias, 0.5 y (1 + erf(y / sqrt 2)) as F.gelu computes it, one
//    store of each valid frame (8 threads write 128 contiguous bytes).
// The wrapper picks TM (ops/cuda/wav2vec2.py:pos_conv_tile) from CG, T and the
// batch. Every frame of the padded batch is computed, as cuDNN does. No
// tensor cores, no TF32, no reduced precision: only the order of the sums
// differs from the plain version, which makes every call's bits the same.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTaps = 4;       // taps a weight stage
constexpr int kFrames = 8;     // frames a thread
constexpr int kLanes = 8;      // threads across a group's output channels
constexpr int kMaxTile = 256;  // threads (frames) a block at most

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// A thread's RN = CG / 8 output channels: RN = 4a + 2b + c, read as a float4
// chunks, then b float2 and c float chunks. Chunk j of width v covers 8v
// channels, thread tn its v channels at tn v: eight threads read one
// contiguous run of 32 v bytes.
template <int RN>
struct Cols {
  static constexpr int kA = RN / 4, kB = (RN % 4) / 2, kC = RN % 2;
  __device__ __forceinline__ static void load(const float* row, int tn, float (&v)[RN]) {
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(row + 32 * j + 4 * tn);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
    if (kB) {
      const float2 q = *reinterpret_cast<const float2*>(row + 32 * kA + 2 * tn);
      v[4 * kA] = q.x;
      v[4 * kA + 1] = q.y;
    }
    if (kC) v[RN - 1] = row[32 * kA + 16 * kB + tn];
  }
  __device__ __forceinline__ static void store(float* row, int tn, const float (&v)[RN]) {
#pragma unroll
    for (int j = 0; j < kA; ++j)
      *reinterpret_cast<float4*>(row + 32 * j + 4 * tn) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    if (kB) *reinterpret_cast<float2*>(row + 32 * kA + 2 * tn) = make_float2(v[4 * kA], v[4 * kA + 1]);
    if (kC) row[32 * kA + 16 * kB + tn] = v[RN - 1];
  }
};

// Stage s of the group's weights (kTaps CG^2 floats) into dst by 16-byte
// cp.async copies, all threads of the block.
template <int CG>
__device__ __forceinline__ void stage_weights(float* dst, const float* wg, int s) {
  constexpr int kChunks = kTaps * CG * CG / 4;
  const float* src = wg + (size_t)s * kTaps * CG * CG;
  for (int c = threadIdx.x; c < kChunks; c += blockDim.x) copy16(dst + 4 * c, src + 4 * c);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int RN>
__global__ void __launch_bounds__(kMaxTile)
pos_conv_gelu_kernel(const float* __restrict__ x,     // (B, T, C)
                     const float* __restrict__ w,     // (G, Kp, CG, CG): [g][k][in][out]
                     const float* __restrict__ bias,  // (C,)
                     float* __restrict__ out,         // (B, T, C)
                     int T, int C, int Kp, int pad) {
  constexpr int CG = kLanes * RN;
  constexpr int kStage = kTaps * CG * CG;
  extern __shared__ __align__(16) float smem[];
  const int tile = blockDim.x;  // TM: a thread per 8 frames and 8 channel groups
  const int ws_len = tile + Kp;  // the window's frames, a multiple of 4
  float* xs = smem;                          // [CG][ws_len]
  float* wbuf = smem + (size_t)CG * ws_len;  // [2][kTaps][CG][CG]
  const int t0 = blockIdx.x * tile, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const float* wg = w + (size_t)g * Kp * CG * CG;
  const int stages = Kp / kTaps;

  stage_weights<CG>(wbuf, wg, 0);  // in flight while the window loads

  // The window, frame fastest: each thread stores consecutive frames of one
  // channel (no bank conflict); frames outside [0, T) are the conv's zeros.
  const float* xb = x + (size_t)b * T * C + (size_t)g * CG;
  for (int e = tid; e < (CG / 4) * ws_len; e += tile) {
    const int q = e / ws_len, f = e - q * ws_len;
    const int src = t0 - pad + f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0 && src < T) v = *reinterpret_cast<const float4*>(xb + (size_t)src * C + 4 * q);
    float* col = xs + (size_t)(4 * q) * ws_len + f;
    col[0] = v.x;
    col[ws_len] = v.y;
    col[2 * ws_len] = v.z;
    col[3 * ws_len] = v.w;
  }

  const int tn = tid % kLanes, tb = (tid / kLanes) * kFrames;
  float acc[kFrames][RN];
#pragma unroll
  for (int r = 0; r < kFrames; ++r)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[r][n] = 0.f;

  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      stage_weights<CG>(wbuf + ((s + 1) & 1) * kStage, wg, s + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // stage s (and, at s = 0, the window) visible to every thread
    const float* wst = wbuf + (s & 1) * kStage;
    const float* xrow = xs + tb + s * kTaps;
#pragma unroll 2
    for (int i = 0; i < CG; ++i) {
      const float4* xp = reinterpret_cast<const float4*>(xrow + (size_t)i * ws_len);
      const float4 p0 = xp[0], p1 = xp[1], p2 = xp[2];
      const float xv[11] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        float wv[RN];
        Cols<RN>::load(wst + (k * CG + i) * CG, tn, wv);
#pragma unroll
        for (int r = 0; r < kFrames; ++r)
#pragma unroll
          for (int n = 0; n < RN; ++n) acc[r][n] = fmaf(xv[r + k], wv[n], acc[r][n]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }

  float bv[RN];
  Cols<RN>::load(bias + (size_t)g * CG, tn, bv);
  float* ob = out + (size_t)b * T * C + (size_t)g * CG;
#pragma unroll
  for (int r = 0; r < kFrames; ++r) {
    const int t = t0 + tb + r;
    if (t >= T) break;
    float y[RN];
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const float v = acc[r][n] + bv[n];
      y[n] = v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
    }
    Cols<RN>::store(ob + (size_t)t * C, tn, y);
  }
}

size_t smem_bytes(int CG, int Kp, int tile) {
  return sizeof(float) * ((size_t)CG * (tile + Kp) + 2 * (size_t)kTaps * CG * CG);
}

template <int RN>
int launch(const float* x, const float* w, const float* bias, float* out, int B, int T, int C,
           int Kp, int pad, int tile, cudaStream_t st) {
  const size_t smem = smem_bytes(kLanes * RN, Kp, tile);
  cudaError_t err = cudaFuncSetAttribute(pos_conv_gelu_kernel<RN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the caller's next launch check does not see it
    return static_cast<int>(err);
  }
  const dim3 grid((T + tile - 1) / tile, C / (kLanes * RN), B);
  pos_conv_gelu_kernel<RN><<<grid, tile, smem, st>>>(x, w, bias, out, T, C, Kp, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.
//
// pos_conv_gelu_smem_bytes: the dynamic shared memory of a block at (CG, Kp,
// tile), as the wrapper's plan computes it.
extern "C" long long pos_conv_gelu_smem_bytes(int CG, int Kp, int tile) {
  return static_cast<long long>(smem_bytes(CG, Kp, tile));
}

// pos_conv_gelu_f32 returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue, before any launch, for what it does not take. The
// wrapper checks shapes and types: x (B, T, C) and out (B, T, C) contiguous
// float32, 16-byte aligned; w (C / CG, Kp, CG, CG) contiguous, Kp a multiple
// of 4, taps at and beyond K zero; bias (C,); CG in {8, 16, ..., 64}
// dividing C; tile a multiple of 32 in [32, 256]; pad = K / 2.
extern "C" int pos_conv_gelu_f32(const float* x, const float* w, const float* bias, float* out,
                                 int B, int T, int C, int CG, int Kp, int pad, int tile,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Kp % kTaps || tile % 32 || tile < 32 || tile > kMaxTile || CG % kLanes || C % CG)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (CG / kLanes) {
    case 1: return launch<1>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 2: return launch<2>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 3: return launch<3>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 4: return launch<4>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 5: return launch<5>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 6: return launch<6>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 7: return launch<7>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    case 8: return launch<8>(x, w, bias, out, B, T, C, Kp, pad, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
