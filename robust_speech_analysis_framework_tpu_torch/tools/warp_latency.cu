// One-warp latency microbenchmark for Hopper (sm_90a): what the dependent
// steps of a single warp cost when they exchange a value between lanes. Each
// kernel runs one warp for n iterations; tools/warp_latency.py times them and
// prints nanoseconds and clocks an item. It backs the design notes of
// csrc/viterbi.cu (the chain warp's exchange of its state) and is no part of
// the port's path.

#include <cuda_runtime.h>

// a chain of dependent FMAs: the ALU latency, and the clock (see k_clock)
extern "C" __global__ void k_fma(float* out, int n, float a, float b) {
  float x = out[threadIdx.x];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) x = fmaf(x, a, b);
  }
  out[threadIdx.x] = x;
}
// a chain of dependent shuffles
extern "C" __global__ void k_shfl_dep(float* out, int n) {
  float x = out[threadIdx.x];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31);
  }
  out[threadIdx.x] = x;
}
// 8 independent shuffles of x, tree-min, back into x
extern "C" __global__ void k_shfl8(float* out, int n) {
  float x = out[threadIdx.x];
  for (int i = 0; i < n; ++i) {
    float c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) c[u] = __shfl_sync(0xffffffffu, x, u) + (float)u;
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < w; ++u) c[u] = fminf(c[u], c[u + w]);
    x = c[0] + 1.0f;
  }
  out[threadIdx.x] = x;
}
// the same with 16
extern "C" __global__ void k_shfl16(float* out, int n) {
  float x = out[threadIdx.x];
  for (int i = 0; i < n; ++i) {
    float c[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) c[u] = __shfl_sync(0xffffffffu, x, u) + (float)u;
#pragma unroll
    for (int w = 8; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < w; ++u) c[u] = fminf(c[u], c[u + w]);
    x = c[0] + 1.0f;
  }
  out[threadIdx.x] = x;
}
// exchange through shared memory: store, syncwarp, two float4 broadcast loads
extern "C" __global__ void k_smem8(float* out, int n) {
  __shared__ __align__(16) float xs[32];
  float x = out[threadIdx.x];
  for (int i = 0; i < n; ++i) {
    xs[threadIdx.x] = x;
    __syncwarp();
    float4 a = *reinterpret_cast<float4*>(xs), b = *reinterpret_cast<float4*>(xs + 4);
    __syncwarp();
    float c[8] = {a.x, a.y + 1, a.z + 2, a.w + 3, b.x + 4, b.y + 5, b.z + 6, b.w + 7};
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < w; ++u) c[u] = fminf(c[u], c[u + w]);
    x = c[0] + 1.0f;
  }
  out[threadIdx.x] = x;
}
// dependent shared-memory loads (pointer chase)
extern "C" __global__ void k_lds_dep(int* out, int n) {
  __shared__ int xs[32];
  xs[threadIdx.x] = (threadIdx.x + 1) & 31;
  __syncwarp();
  int x = threadIdx.x;
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) x = xs[x];
  }
  out[threadIdx.x] = x;
}
// SM clocks against the global nanosecond timer over a chain of FMAs
extern "C" __global__ void k_clock(long long* out, int n, float a, float b) {
  float x = (float)threadIdx.x;
  long long t0 = clock64();
  unsigned long long g0;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(g0));
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) x = fmaf(x, a, b);
  }
  long long t1 = clock64();
  unsigned long long g1;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0) { out[0] = t1 - t0; out[1] = (long long)(g1 - g0); out[2] = (long long)x; }
}
// Plain C entry point for ctypes: launch kernel `which` on one warp; returns
// the cudaError_t of the launch.
extern "C" int run(int which, void* buf, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: k_fma<<<1, 32, 0, s>>>((float*)buf, n, 0.999f, 0.001f); break;
    case 1: k_shfl_dep<<<1, 32, 0, s>>>((float*)buf, n); break;
    case 2: k_shfl8<<<1, 32, 0, s>>>((float*)buf, n); break;
    case 3: k_shfl16<<<1, 32, 0, s>>>((float*)buf, n); break;
    case 4: k_smem8<<<1, 32, 0, s>>>((float*)buf, n); break;
    case 5: k_lds_dep<<<1, 32, 0, s>>>((int*)buf, n); break;
    case 6: k_clock<<<1, 32, 0, s>>>((long long*)buf, n, 0.999f, 0.001f); break;
  }
  return (int)cudaGetLastError();
}
