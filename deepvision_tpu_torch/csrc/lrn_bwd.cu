// Cross-channel Local Response Normalization, backward, for sm_90a.
//
// Replaces: deepvision_tpu/ops/lrn_pallas.py `_bwd` (the analytic VJP that
// `jax.custom_vjp` registers for the Pallas LRN; plain jnp there, which XLA
// fuses into one pass over x and g). With d = k + (alpha/n) * S(x^2):
//
//   dx[r, j] = g * d^-beta - (2 alpha beta / n) * x * S~(g * x * d^(-beta-1))
//
// over the contiguous (rows, C) view of NHWC tensors x and g. S is the
// torch-centred window [i - n/2, i + n - 1 - n/2] clipped to [0, C); S~ is
// its adjoint, the window with mirrored offsets [j - (n - 1 - n/2), j + n/2].
// For odd n the two coincide; for even n (Inception's n = 64 and 192) they
// do not. Math is float32; dx is written in the input dtype.
//
// What bounds it on an H100: device-memory bytes. It reads x and g once and
// writes dx once, about 20 float operations an element whatever n is: far
// below the card's operations-per-byte balance.
//
// The design is the simple one: one warp a row, a persistent grid-stride
// loop over rows. A warp stages its row of x and g in shared memory as
// float32 (coalesced loads), then takes both window sums by prefix sums over
// C, so that any n costs O(C):
// - pass 1 scans x^2 into P (each lane a contiguous chunk of C/32 channels,
//   a warp scan of the chunk totals by __shfl_up_sync, then the chunk's
//   offset added), so S(i) = P(min(i + right, C - 1)) - P(i - half - 1);
// - pass 2 computes d, keeps g * d^-beta in place of g and writes
//   inner = g * x * d^(-beta-1) = g * x * exp2(-(beta + 1) * log2 d) (d >= k
//   > 0, so the power never overflows), and scans inner in place;
// - pass 3 takes S~(j) = Q(min(j + half, C - 1)) - Q(j - right - 1) and
//   writes dx.
// Faster designs (bulk-async row tiles, vector loads, several rows a warp,
// as the forward kernel csrc/lrn.cu has them) are later work.
//
// ptxas report for sm_90a (printed by chip_smoke.py's build phase): 64
// registers a thread in both instantiations, no stack frame, no spills, so
// at most 4 blocks (32 warps) an SM. Shared memory is dynamic, 4 rows of C
// floats a warp: 12 KB a block at C = 96, 32 KB at 256, 96 KB at the
// largest C = 768 (above 48 KB by the opt-in in `launch`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChannels = 768;
constexpr int kBuffers = 4;  // x, g (then g * d^-beta), P, inner (then Q)
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  int c, half, right;
  float alpha_over_n, neg_beta, k, coef;  // coef = 2 alpha beta / n
};

// inclusive prefix sum of v[0..c) in place, by one warp: lane l owns the
// contiguous chunk [l * chunk, (l + 1) * chunk)
__device__ __forceinline__ void warp_prefix_sum(float* v, int c) {
  const int lane = threadIdx.x & 31;
  const int chunk = (c + 31) / 32;
  const int lo = min(lane * chunk, c), hi = min(lo + chunk, c);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  const float offset = incl - run;  // the sum of the chunks before this one
  for (int i = lo; i < hi; ++i) v[i] += offset;
  __syncwarp();
}

// sum of v over [lo, hi] from its inclusive prefix P, clipped to [0, c)
__device__ __forceinline__ float window(const float* p, int lo, int hi,
                                        int c) {
  const float top = p[min(hi, c - 1)];
  return lo > 0 ? top - p[lo - 1] : top;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int64_t rows, Params p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = p.c;
  float* xs = smem + warp * kBuffers * c;
  float* gs = xs + c;
  float* ps = gs + c;
  float* qs = ps + c;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp; r < rows;
       r += nwarps) {
    const T* xr = x + r * c;
    const T* gr = g + r * c;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
      xs[i] = xv;
      gs[i] = to_f32(gr[i]);
      ps[i] = xv * xv;
    }
    __syncwarp();
    warp_prefix_sum(ps, c);
    for (int i = lane; i < c; i += 32) {
      const float d =
          fmaf(p.alpha_over_n, window(ps, i - p.half, i + p.right, c), p.k);
      const float l2 = log2f(d);
      const float gv = gs[i];
      gs[i] = gv * exp2f(p.neg_beta * l2);
      qs[i] = gv * xs[i] * exp2f((p.neg_beta - 1.f) * l2);
    }
    __syncwarp();
    warp_prefix_sum(qs, c);
    T* out = dx + r * c;
    for (int i = lane; i < c; i += 32) {
      const float adj = window(qs, i - p.right, i + p.half, c);
      store(out + i, fmaf(-p.coef * xs[i], adj, gs[i]));
    }
    __syncwarp();  // the next row overwrites the buffers
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, long long rows, int c,
           int size, float alpha_over_n, float beta, float k, void* stream) {
  if (rows <= 0 || c <= 0 || c > kMaxChannels || size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{c,     size / 2, size - 1 - size / 2, alpha_over_n,
                 -beta, k,        2.f * beta * alpha_over_n};
  auto kernel = lrn_backward_kernel<T>;
  const int smem = kWarps * kBuffers * c * static_cast<int>(sizeof(float));
  cudaError_t err = cudaSuccess;
  // the opt-in above 48 KB holds for the current device only, so it is made
  // on every such launch (a cheap host call)
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long wanted = (rows + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(wanted < most ? wanted : most);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      rows, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lrn_backward_max_channels() { return kMaxChannels; }

// x, g, dx: contiguous (rows, c) device buffers of one dtype; stream: a
// cudaStream_t. alpha_over_n is alpha / size. Returns cudaGetLastError()
// after the launch (0 on success), the error of a failed launch set-up, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int lrn_backward_f32(const void* x, const void* g, void* dx, long long rows,
                     int c, int size, float alpha_over_n, float beta, float k,
                     void* stream) {
  return launch<float>(x, g, dx, rows, c, size, alpha_over_n, beta, k,
                       stream);
}

int lrn_backward_bf16(const void* x, const void* g, void* dx, long long rows,
                      int c, int size, float alpha_over_n, float beta,
                      float k, void* stream) {
  return launch<__nv_bfloat16>(x, g, dx, rows, c, size, alpha_over_n, beta,
                               k, stream);
}

}  // extern "C"
