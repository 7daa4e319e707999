// The feature encoder's strided convs conv_1 ... conv_6 for Hopper (sm_90a), fp32,
// in both encoders (Wav2Vec2's group-mode stack, WavLM's layer-mode stack):
// C_in -> C_out channels, K taps at stride s, VALID, read from and written to the
// time-major (B, T, C) layout:
//
//   y[b, t, n] = epilogue(bias[n] + sum_{k < K, c < C_in} x[b, s t + k, c] w[n, c, k])
//
// epilogue = the exact (erf) GELU or nothing, the bias only where one is given.
//
// Why time-major makes it a GEMM. Output frame t of row b reads input frames
// s t ... s t + K - 1 x C_in channels: K C_in contiguous floats starting at
// s t C_in. So within a row the conv is exactly C = A W with
//   A (T_out x K C_in), its rows starting every s C_in floats (they overlap by
//     (K - s) C_in; where K = s they just touch),
//   W (K C_in x C_out), laid out once a call by the wrapper from (C_out, C_in, K).
// Both operands load as 16-byte cp.async rows with no gather and no unfold in
// device memory; the overlapping rows are read again from L2, not from HBM.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (robust_speech_analysis_framework_tpu/models/wav2vec2.py, FeatureEncoder's nn.Conv,
// (B, L, C) in and out). On the card cuDNN ran them as NCHW
// sm80_xmma_fprop_implicit_gemm: 14.32 ms for conv_1-6 of a 16 x 80,000-sample
// Wav2Vec2 batch, ~27 TFLOP/s, then a GELU pass each.
//
// What bounds it on an H100 SXM: operations. 2 B T_out C_out K C_in, 390 GFLOP for
// conv_1-6 of that batch (5.82 ms at the 67 TFLOP/s fp32 FMA rate) against ~1.2 GB
// of input read and output written once (0.36 ms at 3.35 TB/s). So the design
// feeds the FMA pipes and spends few instructions on anything else:
// 1. A block computes a BM x BN tile of the (B T_out) x C_out output (64 x 128
//    or 64 x 64; BM BN / 64 threads), each thread an 8 x 8 patch in registers
//    (rows rg + (BM / 8) r, channels 4 cg + j and BN / 2 + 4 cg + j), 170
//    registers at most: 384 threads an SM, no spill. (A 128 x 128 tile at two
//    blocks of 256 threads an SM, 128 registers and a few spilled, ran conv_1-6
//    of a 16 x 80,000 batch 12 % slower on the H100; so did 64 x 128 at 128.)
// 2. K C_in is walked in stages of 16 floats through a ring of 4 stages in shared
//    memory, filled by cp.async three stages ahead: A as BM rows of 16 floats
//    (padded to 20, so that the four rows a warp reads at once start in banks 0,
//    20, 8 and 28), W as 16 rows of BN channels. A last stage past K C_in, and
//    channels past C_out, are zero-filled copies (any C_in, C_out a multiple of 4).
// 3. Per 4 reduction steps a thread reads its 8 rows' 4 values as 8 float4 and,
//    per step, its 8 weights as 2 float4 (eight threads a contiguous 128 bytes;
//    four rows a warp, eight channel groups: each read a broadcast, no bank
//    conflict), then 64 IEEE fp32 FMAs: 16 shared reads for 256 FMAs.
// 4. Each thread maps its A rows m to (b, t) once: no tile assumes one stride
//    across rows, and rows past B T_out read the last row and are never stored.
// 5. The wrapper (ops/cuda/wav2vec2.py:feature_conv_plan) picks the tile and,
//    where the tiles alone would leave SMs idle (one serving chunk's last convs),
//    splits the reduction over S blocks: each writes its partial tile, and the
//    last of them to arrive (a counter a tile) adds the S partials in split order
//    and runs the epilogue. The order of every sum is fixed by the plan, so each
//    call gives the same bits.
// 6. Epilogue: bias, 0.5 y (1 + erf(y / sqrt 2)) as F.gelu computes it, one float4
//    store of each valid row's channels.
// Every frame of the padded batch is computed, as cuDNN does. No tensor cores, no
// TF32, no reduced precision: only the order of the sums differs from cuDNN's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBK = 16;          // reduction floats a stage
constexpr int kLda = kBK + 4;    // an A row of a stage in shared memory
constexpr int kStages = 4;       // the cp.async ring
constexpr int kPatch = 8;        // a thread's rows, and its channels

template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = BM * BN / (kPatch * kPatch);
  static constexpr int kRowGroups = BM / kPatch;  // threads down the rows
  static constexpr int kWarpRows = BM / 32;       // warps down the rows (4 row groups each)
  static constexpr int kA = BM * kLda;            // floats of A a stage
  static constexpr int kStage = kA + kBK * BN;    // floats of A and W a stage
  static constexpr int kAChunks = BM * kBK / 4 / kThreads;  // 16-byte copies a thread
  static constexpr int kBChunks = kBK * BN / 4 / kThreads;
  static constexpr int kMinBlocks = 384 / kThreads;  // blocks an SM: 170 registers a thread
  static_assert(BM % 32 == 0 && BN % 64 == 0, "a warp is 4 row groups x 8 channel groups");
  static_assert(kAChunks >= 1 && kBChunks >= 1, "every thread copies A and W");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes (src not read) where !valid.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, Tile<BM, BN>::kMinBlocks)
feature_conv_kernel(const float* __restrict__ x,     // (B, T_in, C_in)
                    const float* __restrict__ w,     // (K C_in, C_out)
                    const float* __restrict__ bias,  // (C_out,), read if has_bias
                    float* __restrict__ out,         // (B, T_out, C_out)
                    float* __restrict__ partials,    // (tiles, S, BM BN), if S > 1
                    int* __restrict__ arrivals,      // (tiles,), zero, if S > 1
                    int M, int T_out, int T_in, int C_in, int C_out, int stride, int KC,
                    int splits, int has_bias, int apply_gelu) {
  using Tl = Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n_tiles = (C_out + BN - 1) / BN;
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;

  // This split's stages of the reduction: [first, first + count). A last stage
  // past K C_in, and channels past C_out, are zeros in shared memory.
  const int n_stages = (KC + kBK - 1) / kBK;
  const int per = (n_stages + splits - 1) / splits;
  const int first = split * per;
  const int count = min(n_stages, first + per) - first;

  // A thread's copies keep their rows and columns from stage to stage (the
  // thread counts are multiples of a row's copies, so each keeps one column).
  const int a_k = first * kBK + 4 * (tid % (kBK / 4));  // its A column at stage 0
  const float* a_src[Tl::kAChunks];
  int a_dst[Tl::kAChunks];
#pragma unroll
  for (int i = 0; i < Tl::kAChunks; ++i) {
    const int row = (tid + i * Tl::kThreads) / (kBK / 4);
    const int m = min(m0 + row, M - 1);
    const int b = m / T_out, t = m - b * T_out;
    a_src[i] = x + ((size_t)b * T_in + (size_t)stride * t) * C_in + a_k;
    a_dst[i] = row * kLda + (a_k - first * kBK);
  }
  const int b_n = n0 + 4 * (tid % (BN / 4));  // its W channel
  const int b_k = first * kBK + tid / (BN / 4);  // its W row at stage 0, chunk 0
  const float* b_src = w + (size_t)b_k * C_out + b_n;
  const int b_dst = Tl::kA + (b_k - first * kBK) * BN + (b_n - n0);
  constexpr int kBRows = Tl::kThreads / (BN / 4);  // W rows between a thread's chunks
  auto load_stage = [&](int j) {  // stage first + j into slot j % kStages
    float* base = smem + (j % kStages) * Tl::kStage;
    const bool a_in = a_k + j * kBK < KC;
#pragma unroll
    for (int i = 0; i < Tl::kAChunks; ++i)
      copy16(base + a_dst[i], a_in ? a_src[i] + j * kBK : x, a_in);
#pragma unroll
    for (int i = 0; i < Tl::kBChunks; ++i) {
      const bool in = b_n < C_out && b_k + j * kBK + i * kBRows < KC;
      copy16(base + b_dst + i * kBRows * BN,
             in ? b_src + ((size_t)j * kBK + i * kBRows) * C_out : w, in);
    }
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < count) load_stage(j);
    commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int rg = (warp % Tl::kWarpRows) * 4 + (lane >> 3);
  const int cg = (warp / Tl::kWarpRows) * 8 + (lane & 7);
  float acc[kPatch][kPatch];
#pragma unroll
  for (int r = 0; r < kPatch; ++r)
#pragma unroll
    for (int n = 0; n < kPatch; ++n) acc[r][n] = 0.f;

  for (int j = 0; j < count; ++j) {
    wait_groups<kStages - 2>();
    __syncthreads();  // stage j visible to all; every thread done with stage j - 1's slot
    if (j + kStages - 1 < count) load_stage(j + kStages - 1);
    commit();
    const float* as = smem + (j % kStages) * Tl::kStage + rg * kLda;
    const float* ws = smem + (j % kStages) * Tl::kStage + Tl::kA + 4 * cg;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float a[kPatch][4];
#pragma unroll
      for (int r = 0; r < kPatch; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + r * Tl::kRowGroups * kLda + 4 * kq);
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = ws + (4 * kq + kk) * BN;
        const float4 lo = *reinterpret_cast<const float4*>(wr);
        const float4 hi = *reinterpret_cast<const float4*>(wr + BN / 2);
        const float wv[kPatch] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < kPatch; ++r)
#pragma unroll
          for (int n = 0; n < kPatch; ++n) acc[r][n] = fmaf(a[r][kk], wv[n], acc[r][n]);
      }
    }
  }
  wait_groups<0>();

  if (splits > 1) {
    // Park this split's partial tile (coalesced: float4 i of every thread side by
    // side); the last split to arrive adds them all in split order.
    constexpr int kQuads = BM * BN / 4;
    float4* mine = reinterpret_cast<float4*>(partials) + ((size_t)tile * splits + split) * kQuads;
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mine[(2 * r + h) * Tl::kThreads + tid] = make_float4(
            acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
    __threadfence();
    __syncthreads();
    int last = 0;
    if (tid == 0) last = atomicAdd(arrivals + tile, 1) == splits - 1;
    if (!__syncthreads_or(last)) return;
    __threadfence();
    const float4* all = reinterpret_cast<const float4*>(partials) + (size_t)tile * splits * kQuads;
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (2 * r + h) * Tl::kThreads + tid;
        float4 v = __ldcg(all + i);
        for (int q = 1; q < splits; ++q) {
          const float4 u = __ldcg(all + (size_t)q * kQuads + i);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        acc[r][4 * h] = v.x;
        acc[r][4 * h + 1] = v.y;
        acc[r][4 * h + 2] = v.z;
        acc[r][4 * h + 3] = v.w;
      }
  }

  const int n_lo = n0 + 4 * cg, n_hi = n_lo + BN / 2;  // a thread's two float4 of channels
  const bool lo_in = n_lo < C_out, hi_in = n_hi < C_out;
  float bv[kPatch];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 lo = has_bias && lo_in ? *reinterpret_cast<const float4*>(bias + n_lo) : zero;
  const float4 hi = has_bias && hi_in ? *reinterpret_cast<const float4*>(bias + n_hi) : zero;
  bv[0] = lo.x, bv[1] = lo.y, bv[2] = lo.z, bv[3] = lo.w;
  bv[4] = hi.x, bv[5] = hi.y, bv[6] = hi.z, bv[7] = hi.w;
#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    const int m = m0 + rg + r * Tl::kRowGroups;
    if (m >= M) break;  // rows grow with r
    float y[kPatch];
#pragma unroll
    for (int n = 0; n < kPatch; ++n) {
      const float v = acc[r][n] + bv[n];
      y[n] = apply_gelu ? gelu(v) : v;
    }
    float* orow = out + (size_t)m * C_out;
    if (lo_in) *reinterpret_cast<float4*>(orow + n_lo) = make_float4(y[0], y[1], y[2], y[3]);
    if (hi_in) *reinterpret_cast<float4*>(orow + n_hi) = make_float4(y[4], y[5], y[6], y[7]);
  }
}

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages * Tile<BM, BN>::kStage;
}

template <int BM, int BN>
int launch(const float* x, const float* w, const float* bias, float* out, float* partials,
           int* arrivals, int B, int T_in, int T_out, int C_in, int C_out, int stride, int K,
           int splits, int has_bias, int apply_gelu, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  constexpr int threads = Tile<BM, BN>::kThreads;
  cudaError_t err = cudaFuncSetAttribute(feature_conv_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the caller's next launch check does not see it
    return static_cast<int>(err);
  }
  const int M = B * T_out;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((C_out + BN - 1) / BN) * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  feature_conv_kernel<BM, BN><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      x, w, bias, out, partials, arrivals, M, T_out, T_in, C_in, C_out, stride, K * C_in, splits,
      has_bias, apply_gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.
//
// feature_conv_smem_bytes: a block's dynamic shared memory at tile (BM, BN), as
// the wrapper's plan computes it; 0 for a tile the file does not build.
extern "C" long long feature_conv_smem_bytes(int BM, int BN) {
  if (BM == 64 && BN == 128) return static_cast<long long>(smem_bytes<64, 128>());
  if (BM == 64 && BN == 64) return static_cast<long long>(smem_bytes<64, 64>());
  return 0;
}

// feature_conv_f32 returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue, before any launch, for what it does not take. The wrapper
// checks shapes and types: x (B, T_in, C_in) and out (B, T_out, C_out) contiguous
// float32, 16-byte aligned, T_out = (T_in - K) / stride + 1 >= 1, B T_out < 2^31;
// w (K C_in, C_out) contiguous with w[k C_in + c, n] = weight[n, c, k]; bias
// (C_out,) 16-byte aligned if has_bias; C_in and C_out multiples of 4;
// (BM, BN) one of (64, 128), (64, 64); splits in [1, ceil(K C_in / 16)] leaving no
// split empty; if splits > 1, partials holds tiles x splits x BM BN floats and
// arrivals tiles zeroed ints, tiles = ceil(B T_out / BM) ceil(C_out / BN).
extern "C" int feature_conv_f32(const float* x, const float* w, const float* bias, float* out,
                                float* partials, int* arrivals, int B, int T_in, int T_out,
                                int C_in, int C_out, int stride, int K, int BM, int BN,
                                int splits, int has_bias, int apply_gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_stages = (K * C_in + kBK - 1) / kBK;
  if (B < 1 || T_out < 1 || stride < 1 || K < 1 || C_in % 4 || C_out < 4 || C_out % 4 ||
      T_in < stride * (T_out - 1) + K || splits < 1 || splits > n_stages ||
      (splits - 1) * ((n_stages + splits - 1) / splits) >= n_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BM == 64 && BN == 128)
    return launch<64, 128>(x, w, bias, out, partials, arrivals, B, T_in, T_out, C_in, C_out,
                           stride, K, splits, has_bias, apply_gelu, st);
  if (BM == 64 && BN == 64)
    return launch<64, 64>(x, w, bias, out, partials, arrivals, B, T_in, T_out, C_in, C_out,
                          stride, K, splits, has_bias, apply_gelu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
