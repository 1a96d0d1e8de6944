// Fused cross-channel Local Response Normalization, forward, for sm_90a.
//
// Replaces: deepvision_tpu/ops/lrn_pallas.py `_lrn_kernel` / `_lrn_forward`
// (the Pallas TPU kernel that ops/lrn.py dispatches to on one TPU).
//
//   y[r, i] = x[r, i] / (k + (alpha/n) * sum_{j in W(i)} x[r, j]^2)^beta
//
// over the contiguous (rows, C) view of an NHWC activation, with the
// torch-centred window W(i) = [i - n/2, i + n - 1 - n/2] clipped to [0, C).
// Math is float32; the output is written in the input dtype.
//
// What bounds it on an H100: device-memory bandwidth. The function reads
// the activation once and writes it once (at n=5 it does about a dozen
// float operations per 8 bytes moved in f32, far below the card's
// operations-per-byte balance).
//
// What the design does about it: one pass. Each warp owns one row (one
// pixel, all C channels); it loads the row once with coalesced loads,
// keeps x and x^2 in shared memory, and each lane then walks its channels
// summing the clipped window from shared memory. x^2 and the window sums
// never leave the SM, so device memory sees exactly one read and one
// write of the activation. A wide window (Inception's n=64 and n=192)
// costs O(C*n) shared-memory reads per row; a channel prefix sum would
// make that O(C), and is left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
// Two float arrays (x and x^2) of C entries per warp must fit the 48 KB of
// shared memory a block gets without opting in: 8 * 2 * 768 * 4 = 48 KB.
constexpr int kMaxChannels = 768;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_forward_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   int c, int size, float alpha_over_n, float beta, float k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= rows) return;  // whole warp leaves together: no later sync
  float* xs = smem + static_cast<size_t>(warp) * 2 * c;
  float* sq = xs + c;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  for (int ch = lane; ch < c; ch += 32) {
    const float v = load_f32(xr + ch);
    xs[ch] = v;
    sq[ch] = v * v;
  }
  __syncwarp();

  const int half = size / 2;
  const int right = size - 1 - half;
  for (int ch = lane; ch < c; ch += 32) {
    const int lo = max(ch - half, 0);
    const int hi = min(ch + right, c - 1);
    float s = 0.f;
    for (int j = lo; j <= hi; ++j) s += sq[j];
    const float denom = expf(beta * logf(k + alpha_over_n * s));
    store_from_f32(yr + ch, xs[ch] / denom);
  }
}

template <typename T>
int launch(const void* x, void* y, long long rows, int c, int size,
           float alpha_over_n, float beta, float k, void* stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rows <= 0 || c <= 0 || c > kMaxChannels || size <= 0 ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 2 * c * sizeof(float);
  lrn_forward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, c, size,
      alpha_over_n, beta, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lrn_max_channels() { return kMaxChannels; }

// x, y: contiguous (rows, c) device buffers; stream: a cudaStream_t.
// alpha_over_n is alpha / size, as the TPU kernel scales the window sum.
// Returns cudaGetLastError() after the launch (0 on success).
int lrn_forward_f32(const void* x, void* y, long long rows, int c, int size,
                    float alpha_over_n, float beta, float k, void* stream) {
  return launch<float>(x, y, rows, c, size, alpha_over_n, beta, k, stream);
}

int lrn_forward_bf16(const void* x, void* y, long long rows, int c, int size,
                     float alpha_over_n, float beta, float k, void* stream) {
  return launch<__nv_bfloat16>(x, y, rows, c, size, alpha_over_n, beta, k,
                               stream);
}

}  // extern "C"
