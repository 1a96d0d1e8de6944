// Cross-channel Local Response Normalization, backward, for sm_90a.
//
// Replaces: deepvision_tpu/ops/lrn_pallas.py `_bwd` (the analytic VJP that
// `jax.custom_vjp` registers for the Pallas LRN; plain jnp there, which XLA
// fuses into one pass over x and g). With d = k + (alpha/n) * S(x^2):
//
//   dx[r, j] = a - (2 alpha beta / n) * x * S~(inner),
//   a = g * d^-beta,  inner = a * x / d = g * x * d^(-beta-1)
//
// over the contiguous (rows, C) view of NHWC tensors x and g. S is the
// torch-centred window [i - n/2, i + n - 1 - n/2] clipped to [0, C); S~ is
// its adjoint, the window with mirrored offsets [j - (n - 1 - n/2), j + n/2].
// For odd n the two coincide; for even n (Inception's n = 64 and 192) they
// do not. Math is float32; dx is written in the input dtype.
//
// What bounds it on an H100: device-memory bytes. It reads x and g once and
// writes dx once, about 20 float operations and three transcendentals an
// element whatever n is: far below the card's operations-per-byte balance.
// The design's aim, as the forward's (csrc/lrn.cu), is to keep enough bytes
// in flight and to spend few instructions and little waiting an element.
//
// What the design does about it:
// - Row tiles of x and g staged by bulk asynchronous copies. A tile is R
//   whole rows, R*C*itemsize a multiple of 16; R is the forward's launch
//   plan (ops/lrn_cuda.py `_launch_plan`, about 1.5 KB of x: 96 16-byte
//   vectors, three whole runs of 32 lanes at AlexNet's C = 96 and 256 in
//   bf16 and at C = 96 in f32), so that the CPU tests pin one plan for both
//   kernels. A stage holds an x tile and a g tile; two `cp.async.bulk`
//   copies complete on one mbarrier whose expect_tx is both byte counts.
//   The ragged end of the last tile (under 16 bytes) comes by plain loads
//   after the wait.
// - Warps are independent. Each warp of a persistent grid (as many blocks
//   as fit, from the occupancy calculator) owns a ring of kStages = 2
//   stages; lane 0 keeps the next tile in flight while the warp computes
//   one. No block-wide barrier. Blocks are 4 warps (the forward's are 8):
//   a warp here also holds an f32 copy of its tile, and finer blocks fill
//   the SM's shared memory more evenly (28 warps an SM at LRN1 in f32,
//   where 8-warp blocks would give 24).
// - 16-byte vectors. VEC = 16/itemsize (4 f32, 8 bf16) where C*itemsize
//   is a multiple of 16 (and, on the prefix path, n/2 a multiple of VEC),
//   else 1. A lane reads x and g with one 16-byte
//   shared load each and writes dx with one 16-byte global store, straight
//   from registers.
// - Pass 1 computes, for the lane's VEC channels, S, then a and inner;
//   inner goes as f32 into a per-warp shared buffer of the tile (its
//   neighbours are other lanes'), `a` stays with the lane (KeepA): in
//   registers with 16-byte vectors, where a tile is at most 768 elements
//   and so a lane's vectors at most 24 / VEC, else (VEC = 1) in a second
//   f32 buffer. Recomputing `a` in pass 2 would double the
//   transcendentals. The f32 buffers hold a vector of 8 as two planes of
//   float4, so that 32 lanes on consecutive vectors touch contiguous
//   bytes. After __syncwarp, pass 2 takes S~ of inner and writes
//   dx = a - coef * x * S~.
// - n = 5, AlexNet's window: both windows slid in registers. Pass 1 reads
//   the neighbour vectors of x (a neighbour outside the row reads as 0,
//   which clips the window), squares them and slides S across the lane's
//   VEC channels; pass 2 slides S~ over the neighbour vectors of inner with
//   the mirrored offsets. One add and one subtract an output each.
// - Every other n (Inception's n = 64 and 192, any narrow or even n): O(C)
//   whatever n, by two segmented warp scans over the tile's vectors, as the
//   forward's prefix path: x^2 into the exclusive prefix E, then (pass 1)
//   S(i) = E(i + right + 1) - E(i - half), a and inner, and inner scanned
//   into the inclusive prefix Q; pass 2 takes
//   S~(j) = Q(j + half) - Q(j - right - 1). For even n the four offsets
//   are +-n/2, so where n/2 is a multiple of VEC (Inception's n = 64 and
//   192 in both types) every read is one whole vector: each lane stores its
//   vector's prefix and reads each window end with 16-byte accesses and no
//   per-element addressing (a transposed layout of single floats, read at
//   any offset, cost three instructions a read, and n = 192 took 1.47x
//   the time of n = 5 in bf16, chip_smoke.py on an H100 80GB HBM3 at
//   700 W). Other n take VEC = 1. A prefix row has a pad
//   vector each side; a read's column is clamped into them: zeros on the
//   left, the row's total on the right (written by each scan), so a read
//   past the row's end returns the total. The forward's min(P, total) over
//   +inf pads is right only for the non-decreasing prefix of x^2; Q of the
//   signed inner is not monotone.
// - Fewer instructions: lg2.approx.ftz, ex2.approx.ftz and rcp.approx.ftz
//   once each an element (d^(-beta-1) = d^-beta * (1/d); no divide); the
//   lanes' places in a tile are computed once a launch (make_walk). d >= k
//   > 0 on every path of the model zoo, so flushing subnormals changes
//   nothing there. The build keeps full IEEE behaviour everywhere else (no
//   fast-math).
//
// ptxas report for sm_90a (CUDA 12.8, printed by chip_smoke.py's build
// phase): registers a thread, by type, VEC and path: f32 VEC=4 72 (n=5)
// and 120 (prefix), f32 VEC=1 32 and 40, bf16 VEC=8 72 and 124, bf16
// VEC=1 32 and 40; no stack frame and no spills in any of the eight. The
// 16-byte paths hold `a` (24 floats) in registers by design; registers
// still allow more warps than shared memory does. Shared memory is
// dynamic only (layout_for), a block of 4 warps: 36,992 bytes at both
// AlexNet V1 LRNs in bf16 (6 blocks, 24 warps, an SM), 30,848 at LRN1 and
// 20,608 at LRN2 in f32 (one 1 KB row a tile); 38,016-55,424 on the
// prefix path at Inception's stem (4 blocks an SM in bf16).

#include "lrn_common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// the largest tile (elements) with 16-byte vectors: the launch plan's
// ~1.5 KB, or one row of the widest C, so a lane takes at most 24 / VEC
// vectors a tile (the launcher refuses more)
constexpr int kMaxVecTileElems = 768;

struct Params {
  int c, half, right;
  float alpha_over_n, neg_beta, k, coef;  // coef = 2 alpha beta / n
};

// Shared memory of a block, and each warp's share of it.
struct Layout {
  int bar_bytes;    // all warps' mbarriers
  int tile_bytes;   // one x or g tile, padded to kAlign
  int elems;        // floats of one f32 copy of a tile, padded to 32
  int scan_floats;  // floats of one tile's prefix rows (prefix path)
  int work_floats;  // a warp's f32 buffers
  int bytes;        // the block's total
};

__host__ __device__ constexpr Layout layout_for(int tile_rows, int c,
                                                int itemsize, int vec,
                                                bool prefix) {
  const int tile_bytes = round_up(tile_rows * c * itemsize, kAlign);
  const int elems = round_up(tile_rows * c, 32);
  // the prefix path's rows: C / VEC vectors and a pad vector each side
  const int scan_floats = round_up(tile_rows * (c + 2 * vec), 32);
  // n = 5: inner; prefix: E and Q; then, for VEC = 1 only, a (KeepA)
  const int work_floats =
      (prefix ? 2 * scan_floats : elems) + (vec == 1 ? elems : 0);
  const int bar_bytes = round_up(kWarps * kStages * 8, kAlign);
  return {bar_bytes,   tile_bytes,  elems,
          scan_floats, work_floats,
          bar_bytes + kWarps * (kStages * 2 * tile_bytes + work_floats * 4)};
}

// a warp's f32 copy of a tile, VEC values a vector. For VEC = 8 the two
// float4 halves of vector v lie in two planes of `plane` floats, so that 32
// lanes on consecutive vectors touch contiguous bytes in each 16-byte access
template <int VEC>
struct VecRows {
  float* base;
  int plane;

  __device__ __forceinline__ void load(int v, float (&out)[VEC]) const {
    if constexpr (VEC == 1) {
      out[0] = base[v];
    } else {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        const float4 f = *reinterpret_cast<const float4*>(base + h * plane +
                                                          v * 4);
        out[4 * h] = f.x;
        out[4 * h + 1] = f.y;
        out[4 * h + 2] = f.z;
        out[4 * h + 3] = f.w;
      }
    }
  }

  __device__ __forceinline__ void store(int v, const float (&in)[VEC]) const {
    if constexpr (VEC == 1) {
      base[v] = in[0];
    } else {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        *reinterpret_cast<float4*>(base + h * plane + v * 4) = make_float4(
            in[4 * h], in[4 * h + 1], in[4 * h + 2], in[4 * h + 3]);
      }
    }
  }
};

// a VecRows view of `floats` floats at base
template <int VEC>
__device__ __forceinline__ VecRows<VEC> f32_rows(float* base, int floats) {
  return {base, floats * 4 / (VEC < 4 ? 4 : VEC)};
}

// Where a lane keeps `a` from pass 1 to pass 2. With 16-byte vectors a
// lane takes at most 24 / VEC vectors a tile (kMaxVecTileElems), and keeps
// their `a` in registers: no shared-memory traffic, and no buffer that
// would cost warps an SM. With VEC = 1 (odd C) the count has no bound, and
// `a` goes to a per-warp f32 buffer in shared memory.
template <int VEC>
struct KeepA {
  static constexpr bool kRegs = VEC > 1;
  static constexpr int kRuns = kMaxVecTileElems / (32 * VEC);
  float regs[kRegs ? kRuns : 1][VEC];
  VecRows<VEC> rows;

  // a of the lane's j-th vector of the tile, vector v
  __device__ __forceinline__ void put(int j, int v, const float (&a)[VEC]) {
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) regs[j][i] = a[i];
    } else {
      rows.store(v, a);
    }
  }

  __device__ __forceinline__ void get(int j, int v, float (&a)[VEC]) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[i] = regs[j][i];
    } else {
      rows.load(v, a);
    }
  }
};

// body(j, v0) for each run of 32 vectors of the tile (v0 = 32 j), all
// lanes together; unrolled where KeepA holds `a` in registers, so that j
// is a constant there
template <int VEC, typename Body>
__device__ __forceinline__ void each_run(int nvec, Body body) {
  if constexpr (KeepA<VEC>::kRegs) {
#pragma unroll
    for (int j = 0; j < KeepA<VEC>::kRuns; ++j) {
      if (32 * j >= nvec) break;
      body(j, 32 * j);
    }
  } else {
    for (int v0 = 0; v0 < nvec; v0 += 32) body(0, v0);
  }
}

// a and inner of one element, from its window sum s
__device__ __forceinline__ void grad_terms(float x, float g, float s,
                                           const Params& p, float& a,
                                           float& inner) {
  const float d = fmaf(p.alpha_over_n, s, p.k);
  a = g * fast_exp2(p.neg_beta * fast_log2(d));
  inner = a * x * fast_rcp(d);
}

// ---- n = 5: both windows slid in registers --------------------------------

// the VEC values of vector v of `src` and kH neighbour vectors a side
// (zeros outside the row) into e; `get(v, out)` loads one vector
template <int VEC, int kH, typename Get>
__device__ __forceinline__ void gather(Get get, int v, int cv, int vpr,
                                       float (&e)[(2 * kH + 1) * VEC]) {
#pragma unroll
  for (int h = -kH; h <= kH; ++h) {
    float part[VEC];
    if (h == 0 || static_cast<unsigned>(cv + h) < static_cast<unsigned>(vpr)) {
      get(v + h, part);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) part[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[(h + kH) * VEC + i] = part[i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void slide_tile(const T* xt, const T* gt, T* dxt,
                                           int nrows, const Params& p,
                                           const Walk& w, float* work,
                                           const Layout& L) {
  constexpr int kHalf = kSlideWindow / 2;
  constexpr int kRight = kSlideWindow - 1 - kHalf;
  constexpr int kReach = kHalf > kRight ? kHalf : kRight;
  constexpr int kH = (kReach + VEC - 1) / VEC;  // neighbours a side
  constexpr int kMid = kH * VEC;  // index of the own vector's first value
  constexpr int kE = (2 * kH + 1) * VEC;
  const int lane = threadIdx.x & 31;
  const int nvec = nrows * w.vpr;
  const VecRows<VEC> inner = f32_rows<VEC>(work, L.elems);
  KeepA<VEC> keep;
  keep.rows = f32_rows<VEC>(work + L.elems, L.elems);
  const auto x_at = [&](int v, float (&out)[VEC]) {
    load_vec<T, VEC>(xt + v * VEC, out);
  };
  const auto inner_at = [&](int v, float (&out)[VEC]) { inner.load(v, out); };

  int r = w.r, cv = w.cv;
  each_run<VEC>(nvec, [&](int j, int v0) {  // pass 1: S, a and inner
    const int v = v0 + lane;
    if (v >= nvec) return;
    float e[kE], xv[VEC], gv[VEC], a[VEC], in[VEC];
    gather<VEC, kH>(x_at, v, cv, w.vpr, e);
    load_vec<T, VEC>(gt + v * VEC, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) xv[i] = e[kMid + i];
#pragma unroll
    for (int i = 0; i < kE; ++i) e[i] *= e[i];
    float s = 0.f;
#pragma unroll
    for (int m = -kHalf; m <= kRight; ++m) s += e[kMid + m];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      grad_terms(xv[i], gv[i], s, p, a[i], in[i]);
      if (i + 1 < VEC) s += e[kMid + i + 1 + kRight] - e[kMid + i - kHalf];
    }
    keep.put(j, v, a);
    inner.store(v, in);
    advance(w, r, cv);
  });
  __syncwarp();
  r = w.r;
  cv = w.cv;
  each_run<VEC>(nvec, [&](int j, int v0) {  // pass 2: S~ and dx
    const int v = v0 + lane;
    if (v >= nvec) return;
    float e[kE], xv[VEC], a[VEC], out[VEC];
    gather<VEC, kH>(inner_at, v, cv, w.vpr, e);
    load_vec<T, VEC>(xt + v * VEC, xv);
    keep.get(j, v, a);
    float s = 0.f;
#pragma unroll
    for (int m = -kRight; m <= kHalf; ++m) s += e[kMid + m];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[i] = fmaf(-p.coef * xv[i], s, a[i]);
      if (i + 1 < VEC) s += e[kMid + i + 1 + kHalf] - e[kMid + i - kRight];
    }
    store_vec<T, VEC>(dxt + v * VEC, out);
    advance(w, r, cv);
  });
}

// ---- every other n: two segmented scans, O(C) -----------------------------

// Scans the tile's values, VEC a vector, into prefix rows (RowsOf): the
// lanes take the tile's vectors in turn, each sums its VEC values in
// registers, then a segmented __shfl_up_sync scan adds only what lies in
// the lane's own row (d <= cv), and the running sum of a row that goes on
// into the next 32 vectors is carried there. `value(j, v, r, cv, q)` gives
// vector v's values, the lane's j-th (a valid lane only; the others scan
// zeros). Each lane
// stores its vector's prefix, inclusive or EXCLUSIVE, with 16-byte stores;
// the lane that ends a row stores the row's total into its right pad.
template <int VEC, bool EXCLUSIVE, typename Value>
__device__ __forceinline__ void scan_tile(Value value, int nvec,
                                          const VecRows<VEC>& rows,
                                          const Walk& w) {
  const int lane = threadIdx.x & 31;
  const int cols = w.vpr + 2;
  float carry = 0.f;
  int r = w.r, cv = w.cv;
  each_run<VEC>(nvec, [&](int j, int v0) {
    const bool valid = v0 + lane < nvec;
    float q[VEC];
    if (valid) {
      value(j, v0 + lane, r, cv, q);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) q[i] = 0.f;
    }
    float own[VEC];  // the prefix within the lane's vector
    own[0] = EXCLUSIVE ? 0.f : q[0];
#pragma unroll
    for (int i = 1; i < VEC; ++i) {
      own[i] = EXCLUSIVE ? own[i - 1] + q[i - 1] : own[i - 1] + q[i];
    }
    const int reach = min(cv, lane);  // lanes back within this row
    float incl = EXCLUSIVE ? own[VEC - 1] + q[VEC - 1] : own[VEC - 1];
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
#pragma unroll
      for (int i = 0; i < VEC; ++i) own[i] += excl;
      rows.store(r * cols + cv + 1, own);
      if (cv == w.vpr - 1) {
        float total[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) total[i] = incl;
        rows.store(r * cols + cols - 1, total);
      }
    }
    carry = __shfl_sync(0xffffffffu, incl, 31);
    advance(w, r, cv);
  });
}

// the VEC values from J0 = cv * VEC + off of a prefix row, off a multiple
// of VEC: one vector, its column clamped into the pads (0 left of the row,
// the total right of it)
template <int VEC>
__device__ __forceinline__ void read_at(const VecRows<VEC>& rows, int r,
                                        int cv, int off, const Walk& w,
                                        float (&out)[VEC]) {
  const int cols = w.vpr + 2;
  rows.load(r * cols + min(max(cv + off / VEC + 1, 0), cols - 1), out);
}

template <typename T, int VEC>
__device__ __forceinline__ void prefix_tile(const T* xt, const T* gt, T* dxt,
                                            int nrows, const Params& p,
                                            const Walk& w, float* work,
                                            const Layout& L) {
  const int lane = threadIdx.x & 31;
  const int nvec = nrows * w.vpr;
  // E, the exclusive prefix of x^2, and Q, the inclusive prefix of inner
  const VecRows<VEC> pre = f32_rows<VEC>(work, L.scan_floats);
  const VecRows<VEC> adj = f32_rows<VEC>(work + L.scan_floats, L.scan_floats);
  KeepA<VEC> keep;
  keep.rows = f32_rows<VEC>(work + 2 * L.scan_floats, L.elems);

  scan_tile<VEC, true>(
      [&](int, int v, int, int, float (&q)[VEC]) {
        load_vec<T, VEC>(xt + v * VEC, q);
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] *= q[i];
      },
      nvec, pre, w);
  __syncwarp();
  // S(i) = E(i + right + 1) - E(i - half)
  scan_tile<VEC, false>(
      [&](int j, int v, int r, int cv, float (&q)[VEC]) {
        float xv[VEC], gv[VEC], hi[VEC], lo[VEC], a[VEC];
        load_vec<T, VEC>(xt + v * VEC, xv);
        load_vec<T, VEC>(gt + v * VEC, gv);
        read_at(pre, r, cv, p.right + 1, w, hi);
        read_at(pre, r, cv, -p.half, w, lo);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          grad_terms(xv[i], gv[i], hi[i] - lo[i], p, a[i], q[i]);
        }
        keep.put(j, v, a);
      },
      nvec, adj, w);
  __syncwarp();
  // S~(j) = Q(j + half) - Q(j - right - 1)
  int r = w.r, cv = w.cv;
  each_run<VEC>(nvec, [&](int j, int v0) {
    const int v = v0 + lane;
    if (v >= nvec) return;
    float xv[VEC], a[VEC], hi[VEC], lo[VEC], out[VEC];
    load_vec<T, VEC>(xt + v * VEC, xv);
    keep.get(j, v, a);
    read_at(adj, r, cv, p.half, w, hi);
    read_at(adj, r, cv, -p.right - 1, w, lo);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[i] = fmaf(-p.coef * xv[i], hi[i] - lo[i], a[i]);
    }
    store_vec<T, VEC>(dxt + v * VEC, out);
    advance(w, r, cv);
  });
}

// ---- the persistent kernel ---------------------------------------------

template <typename T, int VEC, bool PREFIX>
__global__ void __launch_bounds__(kThreads)
lrn_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int64_t rows, Params p,
                    int tile_rows) {
  extern __shared__ __align__(kAlign) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L = layout_for(tile_rows, p.c, sizeof(T), VEC, PREFIX);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * kStages;
  unsigned char* ring =
      smem + L.bar_bytes + warp * kStages * 2 * L.tile_bytes;
  float* work = reinterpret_cast<float*>(smem + L.bar_bytes +
                                         kWarps * kStages * 2 *
                                             L.tile_bytes) +
                warp * L.work_floats;
  const Walk walk = make_walk(p.c, VEC);
  const int64_t ntiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;

  // lane 0 asks for tile `t` into stage `s`: the whole-16-byte parts of x
  // and g by two bulk copies on one mbarrier; the rest (under 16 bytes,
  // last tile only) comes after the wait, by plain loads
  auto issue = [&](int64_t t, int s) {
    const int64_t r0 = t * tile_rows;
    const int64_t nrows = rows - r0 < tile_rows ? rows - r0 : tile_rows;
    const uint32_t bytes =
        static_cast<uint32_t>(nrows * p.c * sizeof(T)) & ~15u;
    unsigned char* stage = ring + s * 2 * L.tile_bytes;
    // order the warp's earlier accesses of this stage before the async
    // writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&full[s], 2 * bytes);
    if (bytes) {
      bulk_load(stage, x + r0 * p.c, bytes, &full[s]);
      bulk_load(stage + L.tile_bytes, g + r0 * p.c, bytes, &full[s]);
    }
  };

  if constexpr (PREFIX) {  // the left pads of E and Q: zeros, written once
    const VecRows<VEC> pre = f32_rows<VEC>(work, L.scan_floats);
    const VecRows<VEC> adj = f32_rows<VEC>(work + L.scan_floats, L.scan_floats);
    float zero[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) zero[i] = 0.f;
    for (int r = lane; r < tile_rows; r += 32) {
      pre.store(r * (walk.vpr + 2), zero);
      adj.store(r * (walk.vpr + 2), zero);
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
    T* xt = reinterpret_cast<T*>(ring + s * 2 * L.tile_bytes);
    T* gt = reinterpret_cast<T*>(ring + s * 2 * L.tile_bytes + L.tile_bytes);
    const int64_t r0 = t * tile_rows;
    const int nrows =
        static_cast<int>(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    const int elems = nrows * p.c;
    const int bulk_elems =
        static_cast<int>((static_cast<uint32_t>(elems * sizeof(T)) & ~15u) /
                         sizeof(T));
    if (bulk_elems < elems) {  // warp-uniform: the ragged last tile
      if (lane < elems - bulk_elems) {
        xt[bulk_elems + lane] = x[r0 * p.c + bulk_elems + lane];
        gt[bulk_elems + lane] = g[r0 * p.c + bulk_elems + lane];
      }
      __syncwarp();
    }
    if constexpr (PREFIX) {
      prefix_tile<T, VEC>(xt, gt, dx + r0 * p.c, nrows, p, walk, work, L);
    } else {
      slide_tile<T, VEC>(xt, gt, dx + r0 * p.c, nrows, p, walk, work, L);
    }
    __syncwarp();  // every lane is done with stage s and the f32 buffers
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
int launch_one(const void* x, const void* g, void* dx, long long rows,
               const Params& p, int tile_rows, cudaStream_t stream) {
  auto kernel = lrn_backward_kernel<T, VEC, PREFIX>;
  const int smem =
      layout_for(tile_rows, p.c, sizeof(T), VEC, PREFIX).bytes;
  cudaError_t err = cudaSuccess;
  // the opt-in above 48 KB holds for the current device only, so it is
  // made on every such launch (a cheap host call)
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
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      rows, p, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// VEC is 16 bytes of channels where C (and on the prefix path n) allows
// it, else 1; the window path follows from n.
template <typename T>
int launch(const void* x, const void* g, void* dx, long long rows, int c,
           int size, float alpha_over_n, float beta, float k, int tile_rows,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tile_bytes =
      static_cast<long long>(tile_rows) * c * sizeof(T);
  if (rows <= 0 || c <= 0 || c > kMaxChannels || size <= 0 ||
      tile_rows <= 0 || tile_bytes % 16 != 0 ||
      tile_bytes >= (1LL << 19) ||  // 2 tiles a stage: the mbarrier's
                                    // transaction count is under 2^20
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{c,     size / 2, size - 1 - size / 2, alpha_over_n,
                 -beta, k,        2.f * beta * alpha_over_n};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto vec_c, auto prefix_c) {
    // KeepA holds a lane's `a` in registers for at most
    // kMaxVecTileElems elements a tile
    if (decltype(vec_c)::value > 1 && tile_rows * c > kMaxVecTileElems) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_one<T, decltype(vec_c)::value, decltype(prefix_c)::value>(
        x, g, dx, rows, p, tile_rows, s);
  };
  using Prefix = std::true_type;
  using Slide = std::false_type;
  using V = std::integral_constant<int, kVec>;
  using V1 = std::integral_constant<int, 1>;
  if (size == kSlideWindow) {
    return c % kVec == 0 ? go(V{}, Slide{}) : go(V1{}, Slide{});
  }
  // the prefix path reads whole vectors: its four window offsets
  // (+-n/2 for even n) must be multiples of VEC, else it takes VEC = 1
  const bool whole = c % kVec == 0 && size % 2 == 0 && size / 2 % kVec == 0;
  return whole ? go(V{}, Prefix{}) : go(V1{}, Prefix{});
}

}  // namespace

extern "C" {

int lrn_backward_max_channels() { return kMaxChannels; }

// x, g, dx: contiguous (rows, c) device buffers of one dtype, 16-byte
// aligned; stream: a cudaStream_t. alpha_over_n is alpha / size. tile_rows
// is ops/lrn_cuda.py's `_launch_plan`: rows a tile, whose bytes are a
// multiple of 16. Returns cudaGetLastError() after the launch (0 on
// success), the error of a failed launch set-up, or cudaErrorInvalidValue
// for arguments the kernel does not take.
int lrn_backward_f32(const void* x, const void* g, void* dx, long long rows,
                     int c, int size, float alpha_over_n, float beta, float k,
                     int tile_rows, void* stream) {
  return launch<float>(x, g, dx, rows, c, size, alpha_over_n, beta, k,
                       tile_rows, stream);
}

int lrn_backward_bf16(const void* x, const void* g, void* dx, long long rows,
                      int c, int size, float alpha_over_n, float beta,
                      float k, int tile_rows, void* stream) {
  return launch<__nv_bfloat16>(x, g, dx, rows, c, size, alpha_over_n, beta,
                               k, tile_rows, stream);
}

}  // extern "C"
