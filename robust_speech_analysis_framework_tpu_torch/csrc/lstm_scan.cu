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
// What bounds it on an H100 SXM. At the batch shape (T=2240, G=2, B=128,
// H=128) the recurrent product is 2*T*G*B*H*4H = 75.2 GFLOP (1.12 ms at
// 67 TFLOP/s fp32) and the gates in plus hs out are 1.47 GB (0.44 ms at
// 3.35 TB/s): the card's bound is the arithmetic. But the T steps depend on
// one another, and at the serving and training shapes (B = 1, B = 8, T =
// 4096) there are only 2 to 16 independent rows, so what counts is the time
// of one step on one SM: the weights a step reads (fp32 Wh is H x 4H x 4 B =
// 256 KiB per direction at H = 128), the h it reads, the 4H*H FMAs a row
// (512 clocks of one SM's 128 lanes), and the chain that cannot leave the
// loop: the sums' reduction, three sigmoids and two tanh, the h store and one
// barrier. Measured on an NVIDIA H100 80GB HBM3 at 700 W: 1.11 us a step at
// one row a block (1.75 at two), of which 0.44 are the shared-memory reads
// of Wh, 0.13 the activations and 0.11 the reduction, none of them hidden
// under another; 280 x the card's bound at B = 1 and 3.5 x at the batch shape.
//
// Design. The TPU walked a sequential grid over time blocks and carried h and
// c in VMEM scratch. Blocks on Hopper run in no order, so the whole time loop
// runs inside one block: one launch per layer, a grid of (batch tiles, G),
// one block of 4H threads per BT batch rows of one direction.
//
// * Wh stays on chip for all T steps. 256 KiB is more than the 227 KB of
//   shared memory a block may hold, so each thread copies its 8*NK float4 of
//   the packed Wh once, before the loop: the first WhRegs<BT> of them into
//   registers, the rest into shared memory, one column of w_s a thread (a
//   warp's loads are contiguous, conflict-free; rows of 128*NK columns, so
//   every offset is an immediate). The loop loads no weight
//   from L2 or device memory.
// * Lanes share the h reads. A warp's 16-byte-a-lane shared-memory load takes
//   four clocks whether its lanes read 32 addresses or one, so a thread that
//   sums a whole column reads all of h by broadcast and pays as much for h as
//   for the weights. Here the 8 lanes of two neighbouring units (8 columns:
//   i, f, g, o of units 2j and 2j+1) take the matvec together: lane l reads
//   only the l-th eighth of h (NK float4) and sums it against all 8 columns,
//   then a transposing reduction over the 8 lanes (4 + 2 + 1 shuffles and
//   adds a row) leaves each lane with z of its own column. h of a row lies in
//   shared memory as 8 slices, padded so that a quarter-warp's 8 lanes hit
//   different banks, double-buffered (one __syncthreads a step).
// * Each lane activates its own gate (sigmoid, or tanh in the g lane, taken
//   through the sigmoid so that the warp does not diverge) before the four
//   lanes of a unit exchange i, f, g, o by shuffles: two transcendentals a
//   lane and step instead of five. c lives in registers.
// * The gate inputs of step t+1 are loaded during step t, and the loop walks
//   pointers: no 64-bit index product inside it.
//
// Widths. A lane's slice of h is a whole number of float4 where H % 32 == 0.
// Other widths (H % 8 == 0) run the same code at the next multiple of 32:
// NK = ceil(H / 32), the packed Wh has zero rows past H and the padded part
// of h stays zero, so the sums are exact. Wasted work only at widths no model
// of the repo uses (the CV search space has 64 and 128).
//
// The arithmetic is plain fp32 FMA (no TF32), each lane's partial sum over k
// ascending; the 8 partial sums are added pairwise by the shuffles and the
// gate input last. The plain PyTorch version sums in another order: the
// difference is in the last bits (checked to 1e-5). The batch tile and kSaveC
// change no operation of a row, so K1's and K3's hs are bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// float4 of Wh a thread keeps in registers (of its 8 * NK), by batch tile:
// the most that ptxas fits, without spilling, under the 128 registers a thread
// of a 512-thread block may have, beside 8 accumulators a row. A spill costs
// more than the shared-memory reads it saves: 16 at one row spilled 12 to 56
// bytes and took 1.32 us a step against 1.18 with 14 (NVIDIA H100 80GB HBM3,
// 700 W). Four rows spill at 8 and at 12 and are slower than two passes of two
// rows, eight rows spill hundreds of bytes: the batch tile ends at 2.
template <int BT>
struct WhRegs {
  static constexpr int value = 14;
};
template <>
struct WhRegs<2> {
  static constexpr int value = 12;
};

// Floats between two slices of a row of h: the slice's 4 * NK, padded to an
// odd number of float4 so that the 8 slices start in 8 different bank groups.
__host__ __device__ constexpr int slice_stride(int nk) { return 4 * (nk | 1); }

// The 8 lanes of a group each hold partial sums of the group's 8 columns;
// lane l returns the whole sum of column l. Each round a lane keeps the half
// of the columns its own lies in and hands the other half to its partner.
__device__ __forceinline__ float sum_to_own_column(const float (&a)[8], int l) {
  const bool hi = l & 4, mid = l & 2, lo = l & 1;
  float b[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (hi ? a[4 + i] : a[i]) + __shfl_xor_sync(kFullWarp, hi ? a[i] : a[4 + i], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (mid ? b[2 + i] : b[i]) + __shfl_xor_sync(kFullWarp, mid ? b[i] : b[2 + i], 2);
  return (lo ? c[1] : c[0]) + __shfl_xor_sync(kFullWarp, lo ? c[0] : c[1], 1);
}

// Thread p plays two roles. For the chain it owns gate q = p % 4 of hidden
// unit u = p / 4 (column q*H + u of Wh): the four gates of a unit sit in four
// neighbouring lanes. For the matvec it is lane l = p % 8 of group p / 8
// (units 2(p/8) and 2(p/8)+1): column l of the group is the thread's own.
template <int BT, int NK, bool kSaveC>
__global__ void __launch_bounds__(512) lstm_scan_grouped_kernel(
    const float* __restrict__ gates,  // (T, G, B, 4H)
    const float4* __restrict__ whp,   // (G, 8*NK, 4H) float4, see lstm.py
    float* __restrict__ hs,           // (T, G, B, H)
    float* __restrict__ cs,           // (T, G, B, H) when kSaveC, else unused
    int T, int G, int B, int H) {
  constexpr int kW = 8 * NK;  // float4 of Wh a thread holds
  constexpr int kRegs = WhRegs<BT>::value < kW ? WhRegs<BT>::value : kW;
  constexpr int HS = slice_stride(NK);
  constexpr int kRow = 8 * HS;     // floats of one row of h in shared memory
  constexpr int kCols = 128 * NK;  // threads a block of this NK has at most
  extern __shared__ float4 smem[];
  const int H4 = 4 * H;
  float4* w_s = smem;                                                  // [kW - kRegs][kCols]
  float* h_s = reinterpret_cast<float*>(smem + (kW - kRegs) * kCols);  // [2][BT][8][HS]

  const int p = threadIdx.x;  // 0 .. 4H-1
  const int u = p >> 2;
  const int q = p & 3;
  const int l = p & 7;
  const int g = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int rows = B - b0;  // of the tile that are in the batch

  // Wh of this direction, on chip for the whole scan. Float4 number
  // s = 8*k4 + m holds rows l*4NK + 4*k4 .. +3 of the group's column m.
  const float4* w = whp + (size_t)g * kW * H4 + p;
  float4 wreg[kRegs];
#pragma unroll
  for (int s = 0; s < kRegs; ++s) wreg[s] = __ldg(w + (size_t)s * H4);
#pragma unroll
  for (int s = kRegs; s < kW; ++s) w_s[(s - kRegs) * kCols + p] = __ldg(w + (size_t)s * H4);
  for (int i = p; i < 2 * BT * kRow; i += blockDim.x) h_s[i] = 0.0f;

  const size_t gstep = (size_t)G * B * H4;  // one step of gates
  const size_t hstep = (size_t)G * B * H;   // one step of hs / cs
  const float* gx_at = gates + ((size_t)g * B + b0) * H4 + q * H + u;
  float* hs_at = hs + ((size_t)g * B + b0) * H + u;
  float* cs_at = kSaveC ? cs + ((size_t)g * B + b0) * H + u : nullptr;
  const int h_at = (u / (4 * NK)) * HS + u % (4 * NK);  // unit u in a row of h_s

  float c[BT], gx[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    c[b] = 0.0f;
    gx[b] = b < rows ? __ldg(gx_at + b * H4) : 0.0f;
  }
  // orders the copy of Wh and the zeros of h before the first matvec
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_prev = h_s + (t & 1) * BT * kRow;
    float* h_next = h_s + ((t + 1) & 1) * BT * kRow;

    // The next step's gate inputs, a whole step ahead of their use.
    gx_at += gstep;
    float gx_next[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b)
      gx_next[b] = (t + 1 < T && b < rows) ? __ldg(gx_at + b * H4) : 0.0f;

    // The lane's eighth of h against the group's 8 columns, k ascending.
    float acc[BT][8];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[b][m] = 0.0f;
    const float4* h_l = reinterpret_cast<const float4*>(h_prev + l * HS);
#pragma unroll
    for (int k4 = 0; k4 < NK; ++k4) {
      float4 hv[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) hv[b] = h_l[b * (kRow / 4) + k4];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int s = 8 * k4 + m;  // a constant once unrolled: wreg stays in registers
        const float4 wv = s < kRegs ? wreg[s < kRegs ? s : 0] : w_s[(s - kRegs) * kCols + p];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          acc[b][m] = fmaf(hv[b].x, wv.x, acc[b][m]);
          acc[b][m] = fmaf(hv[b].y, wv.y, acc[b][m]);
          acc[b][m] = fmaf(hv[b].z, wv.z, acc[b][m]);
          acc[b][m] = fmaf(hv[b].w, wv.w, acc[b][m]);
        }
      }
    }

#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float z = gx[b] + sum_to_own_column(acc[b], l);
      // The lane activates its own gate, the g lane as tanh(z) = 2 sigmoid(2z)
      // - 1 so that the warp does not diverge (within 2e-7 of tanhf); the four
      // lanes of unit u then hold i, f, g, o, and every lane computes the same
      // update, so c stays identical across them.
      const float sg = sigmoid_f32(q == 2 ? 2.0f * z : z);
      const float a = q == 2 ? 2.0f * sg - 1.0f : sg;
      const float gi = __shfl_sync(kFullWarp, a, 0, 4);
      const float gf = __shfl_sync(kFullWarp, a, 1, 4);
      const float gg = __shfl_sync(kFullWarp, a, 2, 4);
      const float go = __shfl_sync(kFullWarp, a, 3, 4);
      c[b] = fmaf(gf, c[b], gi * gg);
      const float h = go * tanhf(c[b]);
      if (q == (b & 3)) {
        h_next[b * kRow + h_at] = h;
        if (b < rows) {
          hs_at[b * H] = h;
          if (kSaveC) cs_at[b * H] = c[b];
        }
      }
      gx[b] = gx_next[b];
    }
    hs_at += hstep;
    if (kSaveC) cs_at += hstep;
    // The one barrier of a step: step t+1 reads h_next and writes the other
    // buffer, which every warp has finished reading before it got here.
    __syncthreads();
  }
}

template <int BT, int NK, bool kSaveC>
cudaError_t launch(const float* gates, const float* whp, float* hs, float* cs,
                   int T, int G, int B, int H, cudaStream_t stream) {
  constexpr int kW = 8 * NK;
  constexpr int kRegs = WhRegs<BT>::value < kW ? WhRegs<BT>::value : kW;
  const dim3 grid((B + BT - 1) / BT, G);
  const size_t smem = (size_t)(kW - kRegs) * 128 * NK * sizeof(float4) +
                      2 * (size_t)BT * 8 * slice_stride(NK) * sizeof(float);
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_grouped_kernel<BT, NK, kSaveC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_scan_grouped_kernel<BT, NK, kSaveC><<<grid, 4 * H, smem, stream>>>(
      gates, reinterpret_cast<const float4*>(whp), hs, cs, T, G, B, H);
  return cudaGetLastError();
}

template <int BT, bool kSaveC>
cudaError_t launch_width(const float* gates, const float* whp, float* hs, float* cs,
                         int T, int G, int B, int H, cudaStream_t s) {
  switch ((H + 31) / 32) {  // NK: float4 of a lane's slice of h
    case 1: return launch<BT, 1, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 2: return launch<BT, 2, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 3: return launch<BT, 3, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 4: return launch<BT, 4, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kSaveC>
int launch_tiled(const float* gates, const float* whp, float* hs, float* cs,
                 int T, int G, int B, int H, int batch_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (batch_tile) {
    case 1: return launch_width<1, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
    case 2: return launch_width<2, kSaveC>(gates, whp, hs, cs, T, G, B, H, s);
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
