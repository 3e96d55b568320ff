// Counter-hash lattice of the fused sketch: every Omega element is a pure
// function of (key words, global row, global col).  uint32 arithmetic wraps,
// so the bits equal those of the reference's `counter_bits`
// (repro/kernels/shgemm_fused.py) on any backend.
#pragma once
#include <stdint.h>

namespace shg {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kRowSalt = 0x9E3779B9u;
constexpr uint32_t kColSalt = 0x7F4A7C15u;
constexpr uint32_t kStreamSalt = 0x632BE59Bu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// The lattice's bits at (row, col) of draw `stream` are
// fmix32(row_hash(k0, row) ^ col_hash(k1, col, stream)), the reference's
// counter_bits.  The row hash is shared by every column and stream of a
// row, the column hash (premultiplied by kM1) by every row of a column, so a
// kernel hoists both and pays one fmix32 per element and stream.
__device__ __forceinline__ uint32_t row_hash(uint32_t k0, uint32_t row) {
  return fmix32(row * kRowSalt + k0);
}

__device__ __forceinline__ uint32_t col_hash(uint32_t k1, uint32_t col,
                                             uint32_t stream) {
  return fmix32(col * kColSalt + k1 + stream * kStreamSalt) * kM1;
}

// Top 24 bits -> f32 uniform on [0, 1), plus `offset` (the product is exact,
// so a contracted fma rounds exactly like the reference's mul-then-add).
__device__ __forceinline__ float uniform24(uint32_t bits, float offset) {
  return static_cast<float>(bits >> 8) * 0x1p-24f + offset;
}

// The sample at the lattice point with row hash `hr` and column hashes `hc0`
// (stream 0) and `hc1` (stream 1).  dist 0: Box-Muller on two 24-bit
// uniforms (accurate logf/cosf/sqrtf: this file must not be built with
// --use_fast_math).  dist 1: the sign distributions (achlioptas,
// very_sparse) by f32 thresholds 1/(2s), 1/s.
__device__ __forceinline__ float sample(uint32_t hr, uint32_t hc0, uint32_t hc1,
                                        int dist, float thr1, float thr2) {
  if (dist == 0) {
    float u1 = uniform24(fmix32(hr ^ hc0), 0x1p-25f);
    float u2 = uniform24(fmix32(hr ^ hc1), 0.0f);
    float r = sqrtf(-2.0f * logf(u1));
    return r * cosf(6.28318530717958647692f * u2);
  }
  float u = uniform24(fmix32(hr ^ hc0), 0.0f);
  return u < thr1 ? -1.0f : (u < thr2 ? 1.0f : 0.0f);
}

}  // namespace shg
