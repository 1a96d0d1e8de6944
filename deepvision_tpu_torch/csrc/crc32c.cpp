// CRC32C (Castagnoli) of a host buffer, for the TFRecord reader.
//
// The JAX package's codec (deepvision_tpu/data/tfrecord.py) takes the CRC
// from google_crc32c or from slicing-by-8 in Python, about 22 records of
// 262 KB a second on one core; a reader that checks both CRCs of every
// record at the step's rate needs a compiled one. This file is built by the
// system C++ compiler into a shared library with a plain C interface and
// loaded with ctypes (deepvision_tpu_torch/ops/_build.py, build_host).
//
// Bound: one pass over the bytes. With SSE4.2 one chain of the CPU's crc32
// instruction (_mm_crc32_u64: 8 bytes, a latency of about 3 cycles) gives
// a few GB/s, far above what the reader needs; three interleaved chains
// would go faster still and are not needed. Without SSE4.2, the same
// slicing-by-8 tables as the Python twin.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <nmmintrin.h>
#define DV_HAVE_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][n] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t n = 0; n < 256; ++n)
        t[k][n] = t[0][t[k - 1][n] & 0xFF] ^ (t[k - 1][n] >> 8);
  }
};

const Tables& tables() {
  static const Tables tab;
  return tab;
}

uint32_t crc_tables(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = tables().t;
  while (n >= 8) {
    uint32_t lo;
    std::memcpy(&lo, p, 4);
    crc ^= lo;
    crc = t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^
          t[5][(crc >> 16) & 0xFF] ^ t[4][crc >> 24] ^ t[3][p[4]] ^
          t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#ifdef DV_HAVE_X86
__attribute__((target("sse4.2"))) uint32_t crc_sse42(uint32_t crc,
                                                     const uint8_t* p,
                                                     size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);  // unaligned slices are fine
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool have_sse42() { return __builtin_cpu_supports("sse4.2"); }
#endif

}  // namespace

extern "C" {

// CRC32C of data[0:n] (initial value and final xor 0xFFFFFFFF, as
// google_crc32c.value computes it).
uint32_t dv_crc32c(const uint8_t* data, size_t n) {
#ifdef DV_HAVE_X86
  static const bool sse = have_sse42();
  if (sse) return crc_sse42(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
#endif
  return crc_tables(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
}

// 1 when dv_crc32c uses the crc32 instruction, 0 for the tables.
int dv_crc32c_hardware(void) {
#ifdef DV_HAVE_X86
  return have_sse42() ? 1 : 0;
#else
  return 0;
#endif
}

}  // extern "C"
