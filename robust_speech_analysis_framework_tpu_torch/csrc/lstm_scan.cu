// Grouped LSTM recurrence for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels `lstm_scan_pallas_grouped` / `_kernel_grouped`
// (robust_speech_analysis_framework_tpu/ops/pallas/lstm.py:144-220), at
// G = 1 `lstm_scan_pallas` / `_kernel` (:50-119), and, with kSaveC set, the
// training forward `_lstm_fwd_res_pallas` / `_kernel_fwd_res` (:234-379),
// which also writes every c_t as the residual of the reverse sweep
// (csrc/lstm_train.cu). It computes, for G
// independent recurrences advancing in lockstep (the two directions of one
// biLSTM layer):
//
//     z_t = gates_t[g] + h_{t-1}[g] @ Wh[g]          (gate order i, f, g, o)
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t),                   h_0 = c_0 = 0,
//
// and writes every h_t (and every c_t when kSaveC: the c[b] the thread
// already holds in a register costs one more store per step). State is NOT
// frozen past a sequence's length, as in the TPU kernel: callers only read
// valid frames.
//
// Design. The TPU walked a sequential grid over time blocks and carried h and
// c in VMEM scratch. Blocks on Hopper run in no order, so the whole time loop
// runs inside one block: one launch per layer. Batch rows and groups are
// independent, so the grid is (batch tiles, G). A block owns BT batch rows of
// one group and has 4H threads; thread p owns gate q = p % 4 of hidden unit
// u = p / 4 (column q*H + u of Wh), so the four gates of a unit sit in four
// neighbouring lanes and meet through warp shuffles. h of the tile lives in
// shared memory (double-buffered, so one __syncthreads per step), c lives in
// registers. The arithmetic is plain fp32 FMA (no TF32), matching the plain
// PyTorch version up to summation order.
//
// What bounds it on an H100 SXM. fp32 Wh is H x 4H x 4 B = 256 KiB per
// direction at H = 128, more than the 227 KB of shared memory a block may
// hold, so this first kernel reads Wh through L2 every step (both directions
// are 512 KiB; L2 is 50 MB), packed by the wrapper so that each warp's loads
// are 16-byte and contiguous. At the batch shape (T=2240, G=2, B=128, H=128)
// the recurrent product is 2*T*G*B*H*4H = 75.2 GFLOP (1.12 ms at 67 TFLOP/s
// fp32) and the gates in plus hs out are 1.47 GB (0.44 ms at 3.35 TB/s): the
// card's bound is the arithmetic. This kernel uses only G*B/BT SMs and
// re-reads Wh from L2 every step, so it sits well above that bound. At the
// serving shape (B = 1, T = 4096) the floor is the latency of 4096 dependent
// steps. A step's time is mostly the latency of its matvec's L2 reads, so the
// wrapper gives each block the fewest batch rows that keep one block per SM.
// Later designs: split the 4H columns over the CTAs of a cluster and
// exchange h through distributed shared memory, so Wh stays on chip.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int BT, bool kSaveC>
__global__ void __launch_bounds__(512) lstm_scan_grouped_kernel(
    const float* __restrict__ gates,  // (T, G, B, 4H)
    const float4* __restrict__ whp,   // (G, H/4, 4H) float4, see lstm.py
    float* __restrict__ hs,           // (T, G, B, H)
    float* __restrict__ cs,           // (T, G, B, H) when kSaveC, else unused
    int T, int G, int B, int H) {
  extern __shared__ float4 smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [2][BT][H]

  const int p = threadIdx.x;  // 0 .. 4H-1
  const int u = p >> 2;
  const int q = p & 3;
  const int H4 = 4 * H;
  const int nk4 = H >> 2;
  const int g = blockIdx.y;
  const int b0 = blockIdx.x * BT;

  for (int i = p; i < 2 * BT * H; i += blockDim.x) h_s[i] = 0.0f;
  float c[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) c[b] = 0.0f;
  __syncthreads();

  const float4* w = whp + (size_t)g * nk4 * H4 + p;
  const size_t step_stride = (size_t)G * B * H4;
  const float* gx_base = gates + ((size_t)g * B + b0) * H4 + q * H + u;
  const size_t hs_off = ((size_t)g * B + b0) * H + u;
  float* hs_base = hs + hs_off;
  const size_t hs_step = (size_t)G * B * H;

  for (int t = 0; t < T; ++t) {
    const float* h_prev = h_s + (t & 1) * BT * H;
    float* h_next = h_s + ((t + 1) & 1) * BT * H;

    // Issue this step's gate loads first; the matvec hides their latency.
    float gx[BT];
    const float* gx_t = gx_base + (size_t)t * step_stride;
#pragma unroll
    for (int b = 0; b < BT; ++b)
      gx[b] = (b0 + b < B) ? __ldg(gx_t + (size_t)b * H4) : 0.0f;

    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.0f;
#pragma unroll 4
    for (int k4 = 0; k4 < nk4; ++k4) {
      const float4 wv = __ldg(w + (size_t)k4 * H4);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 hv = reinterpret_cast<const float4*>(h_prev + b * H)[k4];
        acc[b] = fmaf(hv.x, wv.x, acc[b]);
        acc[b] = fmaf(hv.y, wv.y, acc[b]);
        acc[b] = fmaf(hv.z, wv.z, acc[b]);
        acc[b] = fmaf(hv.w, wv.w, acc[b]);
      }
    }

#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float z = gx[b] + acc[b];
      // The four lanes of unit u hold its i, f, g, o pre-activations; every
      // lane computes the same update, so c stays identical across them.
      const float zi = __shfl_sync(0xffffffffu, z, 0, 4);
      const float zf = __shfl_sync(0xffffffffu, z, 1, 4);
      const float zg = __shfl_sync(0xffffffffu, z, 2, 4);
      const float zo = __shfl_sync(0xffffffffu, z, 3, 4);
      c[b] = sigmoid_f32(zf) * c[b] + sigmoid_f32(zi) * tanhf(zg);
      const float h = sigmoid_f32(zo) * tanhf(c[b]);
      if (q == (b & 3)) {
        h_next[b * H + u] = h;
        if (b0 + b < B) {
          const size_t at = (size_t)t * hs_step + (size_t)b * H;
          hs_base[at] = h;
          if (kSaveC) cs[hs_off + at] = c[b];
        }
      }
    }
    __syncthreads();
  }
}

template <int BT, bool kSaveC>
cudaError_t launch(const float* gates, const float* whp, float* hs, float* cs,
                   int T, int G, int B, int H, cudaStream_t stream) {
  const dim3 grid((B + BT - 1) / BT, G);
  const size_t smem = 2 * (size_t)BT * H * sizeof(float);
  lstm_scan_grouped_kernel<BT, kSaveC><<<grid, 4 * H, smem, stream>>>(
      gates, reinterpret_cast<const float4*>(whp), hs, cs, T, G, B, H);
  return cudaGetLastError();
}

template <bool kSaveC>
int launch_tiled(const float* gates, const float* whp, float* hs, float* cs,
                 int T, int G, int B, int H, int batch_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (batch_tile) {
    case 1: return launch<1, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 2: return launch<2, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 4: return launch<4, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 8: return launch<8, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success). The wrapper checks shapes: H % 8 == 0, H <= 128.
extern "C" int lstm_scan_grouped_f32(const float* gates, const float* whp,
                                     float* hs, int T, int G, int B, int H,
                                     int batch_tile, void* stream) {
  return launch_tiled<false>(gates, whp, hs, nullptr, T, G, B, H, batch_tile,
                             stream);
}

// K3: the same recurrence, also writing c_t to cs (T, G, B, H).
extern "C" int lstm_scan_fwd_res_grouped_f32(const float* gates,
                                             const float* whp, float* hs,
                                             float* cs, int T, int G, int B,
                                             int H, int batch_tile,
                                             void* stream) {
  return launch_tiled<true>(gates, whp, hs, cs, T, G, B, H, batch_tile, stream);
}
