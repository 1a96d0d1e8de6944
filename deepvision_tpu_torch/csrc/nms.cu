// Greedy NMS sweep for the YOLO post-process, CUDA C++ for sm_90a.
//
// Replaces the greedy loop of deepvision_tpu/ops/nms.py (nms_indices,
// the lax.fori_loop at :60-64, vmapped over the batch by batched_nms).
// That code is stock XLA, not a TPU kernel; in eager PyTorch the loop is
// K dependent steps of a few launches each (K = 512 on every served and
// evaluated batch), so this is its one native piece. The top-K prefilter
// and the compaction stay torch ops (ops/nms.py).
//
// Input: per image the K boxes (x1, y1, x2, y2) float32 sorted by score
// and the alive seed (score > -inf). Output: the alive mask after the
// sweep: box i, while alive, kills every j > i with IoU(i, j) > thresh.
//
// One block an image:
//   1. the block stages the K boxes in shared memory and computes the
//      K x K "kills" bit matrix into shared memory: row i holds, in
//      ceil(K / 32) words, the bits of the j > i with IoU(i, j) > thresh
//      (K = 512: 512 rows of 16 words, 32 KB). A warp makes one word:
//      lane b tests j = 32 w + b, reading neighbouring boxes (no bank
//      conflict; box i is a broadcast), and a ballot gathers the bits;
//      words wholly at or below the diagonal are skipped;
//   2. one warp walks the rows in order, AND-ing each live row's bits
//      out of the alive words, which it keeps in registers (two a lane,
//      so K <= 2048).
// What bounds it: phase 1's K^2 / 2 IoUs (24 float32 operations
// each, 3.1 M for K = 512 an image) over the card's float32 rate, far
// above the bytes it moves (K boxes in, K flags out); phase 2 is a
// dependent walk of K steps by one warp.
//
// The IoU is ops/iou.py's broadcast_iou, operation for operation in
// float32, with every multiply, add and divide rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn): a contracted
// multiply-add would move pairs across the threshold (trap C18). max and
// min propagate NaN as torch.maximum, torch.minimum and clamp do, so a
// box that overflowed to inf gives the plain version's NaN (never above
// the threshold).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// broadcast_iou(a, b) for one pair, in its order of operations
__device__ __forceinline__ float iou(float4 a, float4 b) {
  float lo_x = nan_max(a.x, b.x), lo_y = nan_max(a.y, b.y);
  float hi_x = nan_min(a.z, b.z), hi_y = nan_min(a.w, b.w);
  float iw = nan_max(__fsub_rn(hi_x, lo_x), 0.0f);
  float ih = nan_max(__fsub_rn(hi_y, lo_y), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float area_a = __fmul_rn(nan_max(__fsub_rn(a.z, a.x), 0.0f),
                           nan_max(__fsub_rn(a.w, a.y), 0.0f));
  float area_b = __fmul_rn(nan_max(__fsub_rn(b.z, b.x), 0.0f),
                           nan_max(__fsub_rn(b.w, b.y), 0.0f));
  float uni = nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  return __fdiv_rn(inter, uni);
}

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ alive_in,
                 uint8_t* __restrict__ alive_out, int k, float thresh) {
  extern __shared__ uint32_t smem[];
  const int words = (k + 31) / 32;
  uint32_t* kills = smem;                       // k rows of `words`
  uint32_t* alive = kills + k * words;          // `words`
  // the k boxes, at the next 16-byte boundary
  float4* box = reinterpret_cast<float4*>(
      (reinterpret_cast<uintptr_t>(alive + words) + 15) & ~uintptr_t(15));
  const size_t image = blockIdx.x;
  const float4* my_boxes = boxes + image * k;

  for (int j = threadIdx.x; j < k; j += blockDim.x) box[j] = my_boxes[j];
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      int j = w * 32 + b;
      if (j < k && alive_in[image * k + j]) bits |= 1u << b;
    }
    alive[w] = bits;
  }
  __syncthreads();

  // 1. the kill bits: one word (32 candidates j) of one row i a warp
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < k * words; t += blockDim.x >> 5) {
    const int i = t / words, w = t % words;
    const int j = w * 32 + lane;
    bool kill = false;
    if (w * 32 + 31 > i)  // some j > i in this word (warp-uniform)
      kill = j > i && j < k && iou(box[i], box[j]) > thresh;
    const uint32_t bits = __ballot_sync(0xffffffffu, kill);
    if (lane == 0) kills[t] = bits;
  }
  __syncthreads();

  // 2. the greedy walk, one warp: lane l keeps alive words l and l + 32
  // in registers; row i's own bit comes by a shuffle from its lane
  if (threadIdx.x < 32) {
    uint32_t a0 = lane < words ? alive[lane] : 0u;
    uint32_t a1 = lane + 32 < words ? alive[lane + 32] : 0u;
    for (int i = 0; i < k; ++i) {
      const int wi = i >> 5;  // warp-uniform: every lane reads one slot
      const uint32_t word = __shfl_sync(0xffffffffu, wi < 32 ? a0 : a1,
                                        wi & 31);
      if ((word >> (i & 31)) & 1u) {
        if (lane < words) a0 &= ~kills[i * words + lane];
        if (lane + 32 < words) a1 &= ~kills[i * words + lane + 32];
      }
    }
    if (lane < words) alive[lane] = a0;
    if (lane + 32 < words) alive[lane + 32] = a1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    alive_out[image * k + j] = (alive[j >> 5] >> (j & 31)) & 1u;
}

size_t smem_bytes(int k) {
  const size_t words = (k + 31) / 32;
  return (k * words + words) * sizeof(uint32_t) + 16 + k * sizeof(float4);
}

}  // namespace

extern "C" {

// The largest K one block takes: its kill bits fit the shared memory
// (227 KB on the H100) and its alive words the walking warp's registers.
int nms_max_k() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int k = 32;
  while (k + 32 <= 2048 && smem_bytes(k + 32) <= static_cast<size_t>(optin))
    k += 32;
  return k;
}

// boxes: (images, k) float4, 16-byte aligned; alive_in, alive_out:
// (images, k) bytes (0 or 1). Returns the launch's cudaError_t.
int nms_sweep_f32(const void* boxes, const void* alive_in, void* alive_out,
                  int images, int k, float thresh, void* stream) {
  if (images == 0 || k == 0) return 0;
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<images, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const uint8_t*>(alive_in),
      static_cast<uint8_t*>(alive_out), k, thresh);
  return cudaGetLastError();
}

}  // extern "C"
