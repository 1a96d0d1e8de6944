// Fused cross-channel Local Response Normalization, forward, for sm_90a.
//
// Replaces: deepvision_tpu/ops/lrn_pallas.py `_lrn_kernel` / `_lrn_forward`
// (the Pallas TPU kernel that ops/lrn.py dispatches to on one TPU).
//
//   y[r, i] = x[r, i] * (k + (alpha/n) * sum_{j in W(i)} x[r, j]^2)^(-beta)
//
// over the contiguous (rows, C) view of an NHWC activation, with the
// torch-centred window W(i) = [i - n/2, i + n - 1 - n/2] clipped to [0, C).
// Math is float32; the output is written in the input dtype.
//
// What bounds it on an H100: device-memory bytes. The function reads the
// activation once and writes it once, and needs about 9 float operations
// an element whatever n is (square, two window adds, scale, add k, log2,
// scale by -beta, exp2, multiply): far below the card's operations-per-byte
// balance. The design's aim is to keep enough bytes in flight and to spend
// few instructions and little waiting an element, so that neither the
// issue rate nor latency becomes the limit before the bytes do.
//
// What the design does about it:
// - Row tiles staged by bulk asynchronous copies. A tile of R consecutive
//   rows is one contiguous span of R*C*itemsize bytes, so one
//   `cp.async.bulk` (1-D TMA; no tensor map) brings it into shared memory
//   and completes on an mbarrier. R*C*itemsize is a multiple of 16, so
//   every tile starts 16-byte aligned for any C (the wrapper raises on a
//   base pointer that is not). The ragged end of the last tile (under 16
//   bytes, where R_last*C*itemsize is not a multiple of 16) comes by plain
//   loads after the barrier.
// - Warps are independent. Each warp of a persistent grid (as many blocks
//   as fit on the card, from the occupancy calculator) owns a ring of
//   kStages = 2 tile buffers and their mbarriers; lane 0 keeps the next
//   tile's copy in flight while the warp computes one, and the warp walks
//   over the tiles (tile = warp's global index + i * all warps). No
//   block-wide barrier: a slow warp never holds the others. Tile i of a
//   warp sits in stage i % kStages and waits with parity (i / kStages) & 1.
// - 16-byte vectors in registers. Where C*itemsize is a multiple of 16,
//   each lane owns VEC = 16/itemsize consecutive channels of a row (4 f32
//   or 8 bf16), reads them with one 16-byte shared load and writes its
//   outputs with one 16-byte global store. Otherwise VEC is 1.
// - n = 5, the zoo's narrow window (AlexNet): the lane also reads the
//   neighbouring vectors (16-byte loads; a neighbour outside the row reads
//   as 0, which clips the window), squares in registers and slides the
//   window sum across its VEC channels with one add and one subtract an
//   output.
// - Every other n (Inception's n = 64 and 192 above all), O(C) whatever n:
//   the lanes walk the tile's vectors as for n = 5 and scan x^2 (VEC
//   values a lane in registers, then a segmented __shfl_up_sync scan that
//   stops at row starts and carries a row on into the next 32 vectors)
//   into padded, transposed prefix rows P in shared memory; then
//   S(i) = min(P(i + right), P(C - 1)) - P(i - half - 1), two conflict-free
//   shared reads an output, with no index clipping (the pads, 0 on the
//   left and +inf on the right, are written once a launch).
//   Cancellation: at Inception V1's stem (C = 64 and 192, input scale 2)
//   P is at most about 10^3, so the f32 error in S is about
//   10^3 * 2^-24 * (a few ulps of accumulation) ~ 1e-4, and it reaches the
//   denominator scaled by alpha/n <= 1.6e-6: about 1e-10, far inside the
//   1e-5 tolerance against the plain version.
// - Fewer instructions: y = x * exp2(-beta * log2(d)) with the approximate
//   intrinsics (lg2.approx.ftz.f32 and ex2.approx.ftz.f32, each about
//   2^-22 relative), no divide; the lanes' places in a tile (divisions by
//   C) are computed once a launch. d >= k > 0 on every path of the model
//   zoo, so flushing subnormals there changes nothing. The build flags keep
//   full IEEE behaviour everywhere else (no fast-math).
//
// ptxas report for sm_90a (CUDA 12.8, printed by chip_smoke.py's build
// phase): registers a thread, by type, VEC and path: f32 VEC=4 46 (n=5)
// and 48 (prefix), f32 VEC=1 40 and 64, bf16 VEC=8 58 and 48, bf16 VEC=1
// 40 and 64; no stack frame and no spills in any of the eight. Shared
// memory is dynamic only (smem_bytes_for): 24,704 bytes a block for both
// AlexNet V1 LRNs in f32 and bf16 but 16,512 for LRN2 in f32 (one 1 KB
// row a tile), 49,600-77,312 on the prefix-sum path at Inception's stem.

#include "lrn_common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// The prefix-sum path's rows. In the padded index J a row holds lpad
// zeros, then P(0..C-1), the inclusive prefix of x^2, then rpad values of
// +inf, so that S(i) = P(min(i + right, C - 1)) - P(i - half - 1)
// (P(j) = 0 for j < 0) is always min(P[lpad + i + right], P(C - 1)) -
// P[lpad + i - half - 1], with no clipping of indices; the pads are
// written once a launch. lpad, rpad and so the stride are multiples of
// VEC, and J is stored transposed, at (J % VEC) * (stride / VEC) + J / VEC:
// the lanes that own consecutive vectors then read and write consecutive
// floats for any window offset (no bank conflicts).
struct PrefixRows {
  int lpad, stride;
};

__host__ __device__ constexpr PrefixRows prefix_rows(int c, int size,
                                                     int vec) {
  return {round_up(size / 2 + 1, vec),
          round_up(size / 2 + 1, vec) + c +
              round_up(size - 1 - size / 2, vec)};
}

// Shared memory a block needs: each warp's mbarriers and ring of kStages
// tiles, and on the prefix-sum path each warp's padded prefix rows of one
// tile and their totals. The kernel lays it out in this order.
int smem_bytes_for(int tile_rows, int c, int itemsize, int vec, int size) {
  return round_up(kWarps * kStages * 8, kAlign) +
         kWarps * kStages * round_up(tile_rows * c * itemsize, kAlign) +
         (size != kSlideWindow
              ? kWarps * tile_rows * (prefix_rows(c, size, vec).stride + 1) *
                    4
              : 0);
}

struct Params {
  int c, half, right;
  float alpha_over_n, neg_beta, k;
};

__device__ __forceinline__ float lrn_out(float x, float s, const Params& p) {
  return x * fast_exp2(p.neg_beta * fast_log2(fmaf(p.alpha_over_n, s, p.k)));
}

// ---- the two window paths over one staged tile, by one warp ---------------

// n = 5, the zoo's narrow window (AlexNet V1 and V2-TF): the lanes take the
// tile's VEC-wide pieces in turn. A lane reads its own vector and its
// neighbours (16-byte shared loads; a neighbour outside the row reads as 0,
// which clips the window, since C % VEC == 0 puts row edges on vector
// edges), squares them in registers, and slides the window sum across its
// VEC channels: one add and one subtract an output.

template <typename T, int VEC>
__device__ __forceinline__ void slide_tile(const T* tile, T* ytile,
                                           int tile_rows, const Params& p,
                                           const Walk& w) {
  constexpr int kHalf = kSlideWindow / 2;
  constexpr int kRight = kSlideWindow - 1 - kHalf;
  constexpr int kH = (kHalf + VEC - 1) / VEC;  // neighbours a side
  constexpr int kMid = kH * VEC;  // index of the own vector's first value
  const int nvec = tile_rows * w.vpr;
  int r = w.r, cv = w.cv;
  for (int v = threadIdx.x & 31; v < nvec; v += 32) {
    const T* row = tile + r * p.c;
    const int ch0 = cv * VEC;
    float e[(2 * kH + 1) * VEC];
#pragma unroll
    for (int h = -kH; h <= kH; ++h) {
      float part[VEC];
      const int ch = ch0 + h * VEC;
      if (h == 0 || static_cast<unsigned>(ch) < static_cast<unsigned>(p.c)) {
        load_vec<T, VEC>(row + ch, part);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) part[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[(h + kH) * VEC + i] = part[i];
    }
    float xv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) xv[i] = e[kMid + i];
#pragma unroll
    for (int i = 0; i < (2 * kH + 1) * VEC; ++i) e[i] *= e[i];
    float out[VEC];
    float s = 0.f;
#pragma unroll
    for (int m = -kHalf; m <= kRight; ++m) s += e[kMid + m];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[i] = lrn_out(xv[i], s, p);
      if (i + 1 < VEC) s += e[kMid + i + 1 + kRight] - e[kMid + i - kHalf];
    }
    store_vec<T, VEC>(ytile + r * p.c + ch0, out);
    r += w.step_r;
    cv += w.step_c;
    if (cv >= w.vpr) {
      cv -= w.vpr;
      ++r;
    }
  }
}

// Every other n, in O(C) whatever n: the lanes take the tile's vectors in
// turn, as in slide_tile, so that every lane works whatever C is. Pass 1
// scans x^2: VEC values a lane in registers, then a segmented
// __shfl_up_sync scan in which a lane adds only what lies in its own row
// (d <= cv), and the running sum of a row that goes on into the next 32
// vectors is carried there. It writes P into the tile's prefix rows and
// each row's total into `tot`. Pass 2 takes each output's window sum from
// two reads of P (PrefixRows), at offsets the same for every vector.
template <typename T, int VEC>
__device__ __forceinline__ void prefix_tile(const T* tile, T* ytile,
                                            int tile_rows, const Params& p,
                                            float* pre, PrefixRows pr,
                                            const Walk& w) {
  const int lane = threadIdx.x & 31;
  const int sv = pr.stride / VEC;  // floats of one transposed column
  const int base = pr.lpad / VEC;
  float* tot = pre + tile_rows * pr.stride;
  int hi_at[VEC], lo_at[VEC];  // where output i's two reads sit
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int h = i + p.right, l = i - p.half - 1;
    const int lm = ((l % VEC) + VEC) % VEC;
    hi_at[i] = (h % VEC) * sv + base + h / VEC;
    lo_at[i] = lm * sv + base + (l - lm) / VEC;
  }
  const int nvec = tile_rows * w.vpr;
  float carry = 0.f;
  int r = w.r, cv = w.cv;
  for (int v0 = 0; v0 < nvec; v0 += 32) {
    const bool valid = v0 + lane < nvec;
    float x[VEC];
    if (valid) {
      load_vec<T, VEC>(tile + r * p.c + cv * VEC, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
    float q[VEC];
    q[0] = x[0] * x[0];
#pragma unroll
    for (int i = 1; i < VEC; ++i) q[i] = fmaf(x[i], x[i], q[i - 1]);
    const int reach = min(cv, lane);  // lanes back within this row
    float incl = q[VEC - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, d);
      if (d <= reach) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (reach == 0) excl = 0.f;
    if (cv > lane) {  // the row began in an earlier run of 32 vectors
      incl += carry;
      excl += carry;
    }
    if (valid) {
      float* prow = pre + r * pr.stride;
#pragma unroll
      for (int i = 0; i < VEC; ++i) prow[i * sv + base + cv] = excl + q[i];
      if (cv == w.vpr - 1) tot[r] = incl;
    }
    carry = __shfl_sync(0xffffffffu, incl, 31);
    r += w.step_r;
    cv += w.step_c;
    if (cv >= w.vpr) {
      cv -= w.vpr;
      ++r;
    }
  }
  __syncwarp();
  r = w.r;
  cv = w.cv;
  for (int v = lane; v < nvec; v += 32) {
    const float* prow = pre + r * pr.stride;
    const float total = tot[r];
    float x[VEC], out[VEC];
    load_vec<T, VEC>(tile + r * p.c + cv * VEC, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float s = fminf(prow[hi_at[i] + cv], total) - prow[lo_at[i] + cv];
      out[i] = lrn_out(x[i], s, p);
    }
    store_vec<T, VEC>(ytile + r * p.c + cv * VEC, out);
    r += w.step_r;
    cv += w.step_c;
    if (cv >= w.vpr) {
      cv -= w.vpr;
      ++r;
    }
  }
  __syncwarp();  // the next tile overwrites the prefix rows
}

// ---- the persistent kernel ---------------------------------------------

template <typename T, int VEC, bool PREFIX>
__global__ void __launch_bounds__(kThreads)
lrn_forward_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   Params p, int tile_rows) {
  extern __shared__ __align__(kAlign) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile_elems = tile_rows * p.c;
  const int stage_bytes = round_up(tile_elems * static_cast<int>(sizeof(T)),
                                   kAlign);
  const int bar_bytes = round_up(kWarps * kStages * 8, kAlign);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * kStages;
  unsigned char* ring = smem + bar_bytes + warp * kStages * stage_bytes;
  const Walk walk = make_walk(p.c, VEC);
  const PrefixRows pr = prefix_rows(p.c, p.half + p.right + 1, VEC);
  float* pre =
      reinterpret_cast<float*>(smem + bar_bytes +
                               kWarps * kStages * stage_bytes) +
      warp * tile_rows * (pr.stride + 1);
  const int64_t ntiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;

  // lane 0 asks for tile `t` into stage `s`: the whole-16-byte part by a
  // bulk copy; the rest (under 16 bytes, last tile only) comes after the
  // wait, by plain loads
  auto issue = [&](int64_t t, int s) {
    const int64_t r0 = t * tile_rows;
    const int64_t nrows = rows - r0 < tile_rows ? rows - r0 : tile_rows;
    const uint32_t bytes =
        static_cast<uint32_t>(nrows * p.c * sizeof(T)) & ~15u;
    // order the warp's earlier reads of this stage before the async write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&full[s], bytes);
    if (bytes) {
      bulk_load(ring + s * stage_bytes, x + r0 * p.c, bytes, &full[s]);
    }
  };

  if constexpr (PREFIX) {  // the pads: written once, kept
    const int pads = pr.stride - p.c;
    for (int j = lane; j < tile_rows * pads; j += 32) {
      int J = j % pads;
      const float v = J < pr.lpad ? 0.f : __int_as_float(0x7f800000);
      J += J < pr.lpad ? 0 : p.c;
      pre[j / pads * pr.stride + (J % VEC) * (pr.stride / VEC) + J / VEC] = v;
    }
  }
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const int64_t t = first + s * nwarps;
      if (t < ntiles) issue(t, s);
    }
  }
  __syncwarp();

  for (int64_t i = 0;; ++i) {
    const int64_t t = first + i * nwarps;
    if (t >= ntiles) break;
    const int s = static_cast<int>(i % kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((i / kStages) & 1));
    T* tile = reinterpret_cast<T*>(ring + s * stage_bytes);
    const int64_t r0 = t * tile_rows;
    const int nrows =
        static_cast<int>(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    const int elems = nrows * p.c;
    const int bulk_elems =
        static_cast<int>((static_cast<uint32_t>(elems * sizeof(T)) & ~15u) /
                         sizeof(T));
    if (bulk_elems < elems) {  // warp-uniform: the ragged last tile
      if (lane < elems - bulk_elems) {
        tile[bulk_elems + lane] = x[r0 * p.c + bulk_elems + lane];
      }
      __syncwarp();
    }
    if constexpr (PREFIX) {
      prefix_tile<T, VEC>(tile, y + r0 * p.c, nrows, p, pre, pr, walk);
    } else {
      slide_tile<T, VEC>(tile, y + r0 * p.c, nrows, p, walk);
    }
    __syncwarp();  // every lane is done with stage s
    if (lane == 0) {
      const int64_t next = t + kStages * nwarps;
      if (next < ntiles) issue(next, s);
    }
  }
}

// The persistent grid: as many blocks as fit on the card at once (by
// registers and shared memory, from the occupancy calculator), or fewer
// where there are fewer tiles than warps.
template <typename T, int VEC, bool PREFIX>
int launch_one(const void* x, void* y, long long rows, const Params& p,
               int tile_rows, cudaStream_t stream) {
  auto kernel = lrn_forward_kernel<T, VEC, PREFIX>;
  const int smem = smem_bytes_for(tile_rows, p.c, sizeof(T), VEC,
                                  p.half + p.right + 1);
  cudaError_t err = cudaSuccess;
  // the opt-in above 48 KB holds for the current device only, so it is
  // made on every such launch (it is a cheap host call)
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
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const long long wanted = (tiles + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(
      wanted < static_cast<long long>(per_sm) * sms ? wanted : per_sm * sms);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<T*>(y), rows, p,
                                           tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// VEC is 16 bytes of channels where C allows it, else 1; the window path
// follows from n.
template <typename T>
int launch(const void* x, void* y, long long rows, int c, int size,
           float alpha_over_n, float beta, float k, int tile_rows,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tile_bytes =
      static_cast<long long>(tile_rows) * c * sizeof(T);
  if (rows <= 0 || c <= 0 || c > kMaxChannels || size <= 0 ||
      tile_rows <= 0 || tile_bytes % 16 != 0 || tile_bytes >= (1LL << 26) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{c, size / 2, size - 1 - size / 2, alpha_over_n, -beta, k};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto vec_c, auto prefix_c) {
    return launch_one<T, decltype(vec_c)::value, decltype(prefix_c)::value>(
        x, y, rows, p, tile_rows, s);
  };
  using Prefix = std::true_type;
  using Slide = std::false_type;
  const bool prefix = size != kSlideWindow;
  if (c % kVec == 0) {
    using V = std::integral_constant<int, kVec>;
    return prefix ? go(V{}, Prefix{}) : go(V{}, Slide{});
  }
  using V = std::integral_constant<int, 1>;
  return prefix ? go(V{}, Prefix{}) : go(V{}, Slide{});
}

}  // namespace

extern "C" {

int lrn_max_channels() { return kMaxChannels; }

// x, y: contiguous (rows, c) device buffers, 16-byte aligned; stream: a
// cudaStream_t. alpha_over_n is alpha / size, as the TPU kernel scales the
// window sum. tile_rows is ops/lrn_cuda.py's `_launch_plan`: rows a tile,
// whose bytes are a multiple of 16. Returns cudaGetLastError() after the
// launch (0 on success), the error of a failed launch set-up, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int lrn_forward_f32(const void* x, void* y, long long rows, int c, int size,
                    float alpha_over_n, float beta, float k, int tile_rows,
                    void* stream) {
  return launch<float>(x, y, rows, c, size, alpha_over_n, beta, k, tile_rows,
                       stream);
}

int lrn_forward_bf16(const void* x, void* y, long long rows, int c, int size,
                     float alpha_over_n, float beta, float k, int tile_rows,
                     void* stream) {
  return launch<__nv_bfloat16>(x, y, rows, c, size, alpha_over_n, beta, k,
                               tile_rows, stream);
}

}  // extern "C"
