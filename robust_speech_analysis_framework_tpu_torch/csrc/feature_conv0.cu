// Wav2Vec2's first feature-encoder block for Hopper (sm_90a), fp32: conv_0
// (one input channel, C output channels, K = 10 taps, stride 5, no bias),
// the norm of each (row, channel) over the row's valid frames, the
// gn_scale / gn_bias affine and the exact (erf) GELU, written once as the
// (B, C, T) float32 tensor that conv_1 reads.
//
// Replaces no TPU kernel: the JAX package leaves this block to XLA
// (robust_speech_analysis_framework_tpu/models/wav2vec2.py, conv_0 and its
// masked channel norm). On the card cuDNN ran conv_0 as
// implicit_convolve_sgemm at ~165 GFLOP/s, ~100x from its bound, and the
// norm, affine and GELU took about nine more passes over its output.
//
// What bounds it on an H100 SXM. Per row, T = (L - 10) / 5 + 1 frames of C
// outputs: at B = 16, L = 80,000, C = 512 the output is 524 MB and the input
// 5 MB, 0.158 ms at 3.35 TB/s; the 10-tap conv is 2.6 GFLOP (0.04 ms at 67
// TFLOP/s fp32). The write bounds it. The CUDA cores are near it too: with
// erff (two polynomial branches, both taken in most warps) an output costs
// ~40 instructions, ~0.15 ms at B = 16.
//
// Design. On the caller's stream, a memset of the rows' tickets and two
// launches, all in one scratch buffer that this file lays out.
// 1. conv0_stats_kernel, a block a (segment of 2048 frames, row). conv_0 is
//    linear in its input, so a channel's masked mean and variance follow from
//    the moments of the row's patches p_t = x[5t .. 5t+9] over its valid
//    frames: mean_c = w_c . m, var_c = w_c' S w_c, with m the patches' mean
//    and S their centred covariance (10 x 10). A block stages its segment's
//    samples in shared memory and takes the segment's mean, then the 55
//    distinct centred products, in float64 (two passes over shared memory;
//    block sums by shuffles and then over warps, in a fixed order). The last
//    block of a row to finish (a ticket counter) merges the segments in
//    order by Chan's formula and writes, per channel, a 16-float record:
//    w[0..9], gn_bias, mean_c, a_c = gn_scale * rsqrt(var_c + eps), zeros.
//    The statistics are thus exact in float64 and never read the conv's
//    output: no pass over the 524 MB.
// 2. conv0_main_kernel, a block a (tile of 128 frames, row), 8 warps. The
//    row's records (C x 64 B) and the tile's 645 samples go to shared memory;
//    lane l of every warp holds the samples of frames t0 + l + 32j, j < 4 (40
//    registers, read at stride 5: no bank conflict). Warp w walks channels
//    w, w + 8, ...: four broadcast float4 reads of the record, then for each
//    of its four frames ten IEEE fp32 FMAs, (h - mean) * a + bias as one
//    FMA, the GELU as PyTorch writes it (y * 0.5 * (1 + erf(y / sqrt 2))),
//    and a store: a warp stores 32 neighbouring frames, 128 B, of one
//    channel (rows of T floats are not 16-byte aligned, so stores are 4 B).
// Every frame, padded ones too, gets its row's formula, as the plain
// version gives it. No tensor cores and no reduced precision anywhere.
//
// Against the plain version (cuDNN conv, the masked norm over the fp32 conv
// output, affine, F.gelu): the conv sums 10 products in another order and
// the statistics are exact rather than fp32 sums of rounded outputs, so the
// two differ by a few fp32 roundings of the normalised value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 10;
constexpr int kStride = 5;
constexpr int kPairs = kTaps * (kTaps + 1) / 2;  // distinct entries of S
constexpr int kPartial = 1 + kTaps + kPairs;     // a segment's n, mean, M2
constexpr int kRec = 16;                         // floats of a channel's record
constexpr unsigned kFull = 0xffffffffu;

constexpr int kStatThreads = 256;
constexpr int kStatWarps = kStatThreads / 32;
constexpr int kSegFrames = 2048;
constexpr int kSegSamples = kSegFrames * kStride + kTaps - kStride;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFrames = 4;  // frames a lane
constexpr int kTile = 32 * kFrames;
constexpr int kTileSamples = kTile * kStride + kTaps - kStride;

__device__ __forceinline__ int valid_frames(const int* lengths, int has_lengths, int b, int T) {
  if (!has_lengths) return T;
  const int n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : n);
}

// v summed over the block into out[0..N) (shared), every thread's part in
// the same order on every call; ends with a barrier.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) red[warp * N + i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kStatThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kStatWarps; ++w) s += red[w * N + i];
    out[i] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kStatThreads)
conv0_stats_kernel(const float* __restrict__ x,        // (B, L)
                   const int* __restrict__ lengths,    // (B,) valid frames
                   int has_lengths,
                   const float* __restrict__ w,        // (C, 10)
                   const float* __restrict__ scale,    // (C,)
                   const float* __restrict__ bias,     // (C,)
                   double* __restrict__ partials,      // (B, S, kPartial)
                   unsigned* __restrict__ tickets,     // (B,), zero on entry
                   float4* __restrict__ records,       // (B, C, 4)
                   int L, int T, int C, float eps) {
  __shared__ float xs[kSegSamples];
  __shared__ double red[kStatWarps * kPairs];
  __shared__ double sums[kPairs];
  __shared__ double mean_s[kTaps], delta_s[kTaps], cov_s[kPairs];
  __shared__ int last;
  const int s = blockIdx.x, S = gridDim.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = valid_frames(lengths, has_lengths, b, T);
  const int t0 = s * kSegFrames;
  const int ns = max(0, min(kSegFrames, n - t0));
  double* part = partials + ((size_t)b * S + s) * kPartial;

  if (ns > 0) {
    const float* xb = x + (size_t)b * L + (size_t)t0 * kStride;
    const int samples = ns * kStride + kTaps - kStride;
    for (int i = tid; i < samples; i += kStatThreads) xs[i] = xb[i];
    __syncthreads();
    double acc[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[k] = 0.0;
    for (int t = tid; t < ns; t += kStatThreads) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc[k] += (double)xs[t * kStride + k];
    }
    block_sum<kTaps>(acc, red, sums);
    double m[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) m[k] = sums[k] / ns;
    double q[kPairs];
#pragma unroll
    for (int e = 0; e < kPairs; ++e) q[e] = 0.0;
    for (int t = tid; t < ns; t += kStatThreads) {
      double d[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) d[k] = (double)xs[t * kStride + k] - m[k];
      int e = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
#pragma unroll
        for (int k = j; k < kTaps; ++k, ++e) q[e] = fma(d[j], d[k], q[e]);
      }
    }
    block_sum<kPairs>(q, red, sums);
    if (tid == 0) part[0] = ns;
    if (tid < kTaps) part[1 + tid] = m[tid];
    if (tid < kPairs) part[1 + kTaps + tid] = sums[tid];
  } else if (tid == 0) {
    part[0] = 0.0;
  }

  // the last block of the row to finish merges the row's segments
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b], 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // (pj, pk): this thread's entry of S, the tid-th pair j <= k of the upper
  // triangle in row order (tid < kPairs)
  int pj = 0, pk = tid;
  while (pj < kTaps - 1 && pk >= kTaps - pj) pk -= kTaps - pj++;
  pk += pj;
  if (tid < kTaps) mean_s[tid] = 0.0;
  double count = 0.0, m2 = 0.0;
  __syncthreads();
  for (int p = 0; p < S; ++p) {
    const double* q = partials + ((size_t)b * S + p) * kPartial;
    const double nb = __ldcg(q);
    if (nb == 0.0) continue;  // the same for the whole block
    const double na = count;
    count = na + nb;
    const double f = nb / count;
    if (tid < kTaps) delta_s[tid] = __ldcg(q + 1 + tid) - mean_s[tid];
    __syncthreads();
    if (tid < kPairs) m2 += __ldcg(q + 1 + kTaps + tid) + delta_s[pj] * delta_s[pk] * (na * f);
    if (tid < kTaps) mean_s[tid] += delta_s[tid] * f;
    __syncthreads();
  }
  if (tid < kPairs) cov_s[tid] = count > 0.0 ? m2 / count : 0.0;
  __syncthreads();

  for (int c = tid; c < C; c += kStatThreads) {
    double wc[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) wc[k] = (double)w[c * kTaps + k];
    double mean = 0.0, var = 0.0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) mean = fma(wc[k], mean_s[k], mean);
    int e = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
#pragma unroll
      for (int k = j; k < kTaps; ++k, ++e)
        var = fma((j == k ? 1.0 : 2.0) * wc[j] * wc[k], cov_s[e], var);
    }
    const double a = (double)scale[c] / sqrt(fmax(var, 0.0) + (double)eps);
    float4* r = records + ((size_t)b * C + c) * (kRec / 4);
    r[0] = make_float4(w[c * kTaps + 0], w[c * kTaps + 1], w[c * kTaps + 2], w[c * kTaps + 3]);
    r[1] = make_float4(w[c * kTaps + 4], w[c * kTaps + 5], w[c * kTaps + 6], w[c * kTaps + 7]);
    r[2] = make_float4(w[c * kTaps + 8], w[c * kTaps + 9], bias[c], (float)mean);
    r[3] = make_float4((float)a, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
conv0_main_kernel(const float* __restrict__ x,         // (B, L)
                  const float4* __restrict__ records,  // (B, C, 4)
                  float* __restrict__ out,             // (B, C, T)
                  int L, int T, int C) {
  extern __shared__ float4 smem[];
  float4* rec = smem;                                  // (C, 4)
  float* xs = reinterpret_cast<float*>(smem + 4 * C);  // kTileSamples
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, tid = threadIdx.x;
  const float4* rb = records + (size_t)b * C * 4;
  for (int i = tid; i < 4 * C; i += kThreads) rec[i] = rb[i];
  const float* xb = x + (size_t)b * L + (size_t)t0 * kStride;
  const int avail = L - t0 * kStride;  // samples of the row from the tile's first on
  for (int i = tid; i < kTileSamples; i += kThreads) xs[i] = i < avail ? xb[i] : 0.f;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  float xr[kFrames][kTaps];
#pragma unroll
  for (int j = 0; j < kFrames; ++j) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) xr[j][k] = xs[(lane + 32 * j) * kStride + k];
  }
  const int left = T - t0 - lane;  // frame lane + 32j is stored where 32j < left
  float* ob = out + (size_t)b * C * T + t0 + lane;
  for (int c = warp; c < C; c += kWarps) {
    const float4 r0 = rec[4 * c], r1 = rec[4 * c + 1], r2 = rec[4 * c + 2];
    const float a = rec[4 * c + 3].x;
    float* oc = ob + (size_t)c * T;
#pragma unroll
    for (int j = 0; j < kFrames; ++j) {
      float h = r0.x * xr[j][0];
      h = fmaf(r0.y, xr[j][1], h);
      h = fmaf(r0.z, xr[j][2], h);
      h = fmaf(r0.w, xr[j][3], h);
      h = fmaf(r1.x, xr[j][4], h);
      h = fmaf(r1.y, xr[j][5], h);
      h = fmaf(r1.z, xr[j][6], h);
      h = fmaf(r1.w, xr[j][7], h);
      h = fmaf(r2.x, xr[j][8], h);
      h = fmaf(r2.y, xr[j][9], h);
      const float y = fmaf(h - r2.w, a, r2.z);
      const float g = y * 0.5f * (1.0f + erff(y * 0.70710678118654752440f));
      if (32 * j < left) oc[32 * j] = g;
    }
  }
}

// The scratch a call takes, as conv0_scratch lays it out: the segments'
// float64 moments (B, S, kPartial), S = ceil(T / 2048), then the records
// (B, C, kRec) float32, then the tickets (B,) unsigned.
struct Scratch {
  double* partials;
  float4* records;
  unsigned* tickets;
};

size_t conv0_scratch(int B, int T, int C, char* base, Scratch* s) {
  const size_t segments = (T + kSegFrames - 1) / kSegFrames;
  const size_t partials = (size_t)B * segments * kPartial * sizeof(double);
  const size_t records = (size_t)B * C * kRec * sizeof(float);
  if (s != nullptr) {
    s->partials = reinterpret_cast<double*>(base);
    s->records = reinterpret_cast<float4*>(base + partials);  // 66 doubles = 33 x 16 B
    s->tickets = reinterpret_cast<unsigned*>(base + partials + records);
  }
  return partials + records + (size_t)B * sizeof(unsigned);
}

}  // namespace

// Plain C entry points for ctypes.
//
// conv0_norm_gelu_scratch_bytes: the bytes of device scratch that a call of
// conv0_norm_gelu_f32 at (B, T, C) takes.
extern "C" long long conv0_norm_gelu_scratch_bytes(int B, int T, int C) {
  return static_cast<long long>(conv0_scratch(B, T, C, nullptr, nullptr));
}

// conv0_norm_gelu_f32 returns the cudaError_t of the launches (0 on
// success); a C whose records do not fit a block's shared memory returns
// cudaFuncSetAttribute's error before any launch, cleared from the
// runtime's last error. The wrapper checks shapes
// and types: x (B, L) and w (C, 10) contiguous float32, L >= 10, T = (L -
// 10) / 5 + 1, lengths (B,) int32 valid frames when has_lengths (else every
// frame is valid and lengths is not read), scratch of
// conv0_norm_gelu_scratch_bytes(B, T, C) bytes, 16-byte aligned, out (B, C,
// T) float32.
extern "C" int conv0_norm_gelu_f32(const float* x, const int* lengths, const float* w,
                                   const float* scale, const float* bias, void* scratch,
                                   float* out, int B, int L, int T, int C, int has_lengths,
                                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)C * kRec * sizeof(float) + kTileSamples * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv0_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the caller's next launch check does not see it
    return static_cast<int>(err);
  }
  Scratch s;
  conv0_scratch(B, T, C, static_cast<char*>(scratch), &s);
  err = cudaMemsetAsync(s.tickets, 0, (size_t)B * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segments = (T + kSegFrames - 1) / kSegFrames;
  conv0_stats_kernel<<<dim3(segments, B), kStatThreads, 0, st>>>(
      x, lengths, has_lengths, w, scale, bias, s.partials, s.tickets, s.records, L, T, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv0_main_kernel<<<dim3((T + kTile - 1) / kTile, B), kThreads, smem, st>>>(
      x, s.records, out, L, T, C);
  return static_cast<int>(cudaGetLastError());
}
