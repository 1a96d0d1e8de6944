// Shared by the LRN kernels, csrc/lrn.cu (forward) and csrc/lrn_bwd.cu
// (backward): limits, the mbarrier and bulk-copy PTX helpers, the
// approximate transcendentals, typed 16-byte vector access and a lane's
// walk over a staged tile. Each source is its own shared library
// (ops/_build.py), so the helpers sit in an unnamed namespace; the build
// digest covers this header, so editing it rebuilds both kernels.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 768;
constexpr int kStages = 2;       // tiles a warp holds: one computed, one loading
constexpr int kAlign = 128;      // shared-memory alignment of each region
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in
// the window slid in registers; every other n takes the prefix-sum path
constexpr int kSlideWindow = 5;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// ---- PTX helpers: mbarrier and bulk copy -------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// spins until the phase of parity `parity` completes; a wait that never
// ends (a lost copy) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- math ----------------------------------------------------------------

__device__ __forceinline__ float fast_log2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1/v, about 1 ulp; no divide
__device__ __forceinline__ float fast_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// ---- typed vector access ---------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive values of type T at p (16-byte aligned when VEC*size is
// 16) into f32 registers
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(raw.x);
      v[1] = __uint_as_float(raw.y);
      v[2] = __uint_as_float(raw.z);
      v[3] = __uint_as_float(raw.w);
    } else {
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    if constexpr (sizeof(T) == 4) {
      raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
      raw = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // one 16-byte store (the compiler would otherwise split it)
    asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "r"(raw.x), "r"(raw.y), "r"(raw.z), "r"(raw.w)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (sizeof(T) == 4) {
        p[i] = v[i];
      } else {
        p[i] = __float2bfloat16(v[i]);
      }
    }
  }
}

// A lane's fixed place in the walks over a tile, computed once a launch:
// the divisions by C would otherwise cost more than a vector's math.
struct Walk {
  int vpr;                    // vectors a row
  int r, cv, step_r, step_c;  // first (row, vector), and the step of 32
};

__device__ __forceinline__ Walk make_walk(int c, int vec) {
  const int lane = threadIdx.x & 31;
  Walk w;
  w.vpr = c / vec;
  w.r = lane / w.vpr;
  w.cv = lane % w.vpr;
  w.step_r = 32 / w.vpr;
  w.step_c = 32 % w.vpr;
  return w;
}

// the lane's next (row, vector) in the walk, 32 vectors on
__device__ __forceinline__ void advance(const Walk& w, int& r, int& cv) {
  r += w.step_r;
  cv += w.step_c;
  if (cv >= w.vpr) {
    cv -= w.vpr;
    ++r;
  }
}

}  // namespace
