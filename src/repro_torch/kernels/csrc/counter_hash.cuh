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

__device__ __forceinline__ uint32_t counter_bits(uint32_t k0, uint32_t k1,
                                                 uint32_t row, uint32_t col,
                                                 uint32_t stream) {
  uint32_t hr = fmix32(row * kRowSalt + k0);
  uint32_t hc = fmix32(col * kColSalt + k1 + stream * kStreamSalt);
  return fmix32(hr ^ (hc * kM1));
}

// Top 24 bits -> f32 uniform on [0, 1), plus `offset` (the product is exact,
// so a contracted fma rounds exactly like the reference's mul-then-add).
__device__ __forceinline__ float uniform24(uint32_t bits, float offset) {
  return static_cast<float>(bits >> 8) * 0x1p-24f + offset;
}

// dist 0: Box-Muller on two 24-bit uniforms (accurate logf/cosf/sqrtf: this
// file must not be built with --use_fast_math).  dist 1: the sign
// distributions (achlioptas, very_sparse) by f32 thresholds 1/(2s), 1/s.
__device__ __forceinline__ float sample(uint32_t k0, uint32_t k1, uint32_t row,
                                        uint32_t col, int dist, float thr1,
                                        float thr2) {
  if (dist == 0) {
    float u1 = uniform24(counter_bits(k0, k1, row, col, 0), 0x1p-25f);
    float u2 = uniform24(counter_bits(k0, k1, row, col, 1), 0.0f);
    float r = sqrtf(-2.0f * logf(u1));
    return r * cosf(6.28318530717958647692f * u2);
  }
  float u = uniform24(counter_bits(k0, k1, row, col, 0), 0.0f);
  return u < thr1 ? -1.0f : (u < thr2 ? 1.0f : 0.0f);
}

}  // namespace shg
