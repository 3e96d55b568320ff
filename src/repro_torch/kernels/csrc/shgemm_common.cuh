// Split-precision GEMM main loop shared by shgemm.cu and shgemm_fused.cu:
// C_f32[M, N] = A_f32[M, K] @ B_lowp[K, N], B in bf16 or fp16.
//
// Each block owns one (BM, BN) output tile and walks K itself (Hopper blocks
// run in no order, so the loop replaces the TPU's sequential K grid axis).
// A stage is BKS = 32 deep: the f32 A tile and the low-precision B tile sit
// in shared memory, B transposed to (n, k) so a B fragment is one 32-bit
// load.  Each warp owns a 32x32 sub-tile: 2 x 4 mma.sync m16n8k16 tiles.
// A fragments are split in registers into `terms` low-precision parts
// (paper Eq. 37-38; fp16 scales the residual by 2^11 and the correction
// product by 2^-11), one MMA per term, each term into its own f32 partial.
// Every `bk` of K the partials are summed (P0 + P1 + P2) and added to the
// f32 accumulator with RN f32 adds -- the Pallas body
// `acc = 0; acc += term; acc_ref += acc` -- so the tensor cores' own
// accumulation is confined to one bk tile, and the per-element summation
// order depends on bk alone, never on BM or BN.
//
// The caller guarantees M % BM == 0, N % BN == 0, K % bk == 0,
// bk % BKS == 0, 16-byte-aligned A and B, and contiguous row-major layouts.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace shg {

constexpr int BKS = 32;           // K depth of one shared-memory stage
constexpr int A_STRIDE = BKS + 8; // floats; conflict-free float2 reads
constexpr int B_STRIDE = BKS + 8; // 16-bit words; conflict-free 32-bit reads

template <typename T>
struct LowP;

template <>
struct LowP<__nv_bfloat16> {
  static __device__ __forceinline__ uint16_t round(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float widen(uint16_t h) {
    return __bfloat162float(__ushort_as_bfloat16(h));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct LowP<__half> {
  static __device__ __forceinline__ uint16_t round(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  static __device__ __forceinline__ float widen(uint16_t h) {
    return __half2float(__ushort_as_half(h));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <int BM, int BN>
struct Tile {
  static constexpr int THREADS = BM * BN / 32;  // one warp per 32x32
  static constexpr int WARPS_N = BN / 32;
};

// The main loop.  `Producer` fills the (BN, BKS) transposed B stage:
//   prod.fetch(k0)  -- start reading stage k0 (into registers), may be a no-op
//   prod.store(Bs, k0) -- write stage k0 into shared memory
template <typename T, int BM, int BN, class Producer>
__device__ __forceinline__ void shgemm_mainloop(const float* __restrict__ A,
                                                float* __restrict__ C, int N,
                                                int K, int bk, int terms,
                                                Producer& prod) {
  constexpr int NT = Tile<BM, BN>::THREADS;
  constexpr int WN = Tile<BM, BN>::WARPS_N;
  constexpr int A_VECS = BM * BKS / 4;  // float4 per A stage
  static_assert(A_VECS % NT == 0, "A stage must split evenly");
  constexpr int A_PER = A_VECS / NT;
  constexpr bool kFp16 = std::is_same<T, __half>::value;

  __shared__ __align__(16) float As[BM * A_STRIDE];
  __shared__ __align__(16) uint16_t Bs[BN * B_STRIDE];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[2][4][4];
  float part[3][2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  float4 a_reg[A_PER];
  auto fetch_a = [&](int k0) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / (BKS / 4), c = (idx % (BKS / 4)) * 4;
      a_reg[j] = *reinterpret_cast<const float4*>(
          A + static_cast<size_t>(m0 + r) * K + k0 + c);
    }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / (BKS / 4), c = (idx % (BKS / 4)) * 4;
      *reinterpret_cast<float4*>(&As[r * A_STRIDE + c]) = a_reg[j];
    }
  };

  const int nstages = K / BKS;
  const int per_tile = bk / BKS;
  fetch_a(0);
  prod.fetch(0);
  for (int s = 0; s < nstages; ++s) {
    if (s % per_tile == 0) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[t][i][j][e] = 0.0f;
    }
    store_a();
    prod.store(Bs, s * BKS);
    __syncthreads();
    if (s + 1 < nstages) {  // next stage's global reads overlap this MMA
      fetch_a((s + 1) * BKS);
      prod.fetch((s + 1) * BKS);
    }
#pragma unroll
    for (int kk = 0; kk < BKS; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* p = Bs + (wn * 32 + nt * 8 + g) * B_STRIDE + kk + 2 * t4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* pa = As + (wm * 32 + mt * 16 + g) * A_STRIDE + kk + 2 * t4;
        const float2 v0 = *reinterpret_cast<const float2*>(pa);
        const float2 v1 = *reinterpret_cast<const float2*>(pa + 8 * A_STRIDE);
        const float2 v2 = *reinterpret_cast<const float2*>(pa + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(pa + 8 * A_STRIDE + 8);
        float r[8] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y, v3.x, v3.y};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (t < terms) {
            uint32_t h[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const uint16_t q = LowP<T>::round(r[e]);
              h[e] = q;
              r[e] = r[e] - LowP<T>::widen(q);
              if (kFp16 && t == 0) r[e] = r[e] * 2048.0f;  // paper Eq. 38
            }
            const uint32_t af[4] = {h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                    h[4] | (h[5] << 16), h[6] | (h[7] << 16)};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) LowP<T>::mma(part[t][mt][nt], af, bf[nt]);
          }
        }
      }
    }
    __syncthreads();
    if ((s + 1) % per_tile == 0) {  // bk boundary: RN f32 adds, fixed order
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float tile = part[0][i][j][e];
            if (terms > 1) tile = tile + (kFp16 ? part[1][i][j][e] * 0x1p-11f
                                                 : part[1][i][j][e]);
            if (terms > 2) tile = tile + part[2][i][j][e];
            acc[i][j][e] = acc[i][j][e] + tile;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * 32 + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(C + static_cast<size_t>(row) * N + col) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(C + static_cast<size_t>(row + 8) * N + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace shg

// Dispatch the runtime block shape (bm, bn) and the 16-bit type to a kernel
// instantiation: BM in {32, 64, 128}, BN in {32, 64}.
#define SHG_DISPATCH(bm, bn, fp16, LAUNCH)                        \
  do {                                                            \
    if (fp16) {                                                   \
      SHG_DISPATCH_T(__half, bm, bn, LAUNCH);                     \
    } else {                                                      \
      SHG_DISPATCH_T(__nv_bfloat16, bm, bn, LAUNCH);              \
    }                                                             \
  } while (0)

#define SHG_DISPATCH_T(T, bm, bn, LAUNCH)                         \
  if (bm == 128 && bn == 64) { LAUNCH(T, 128, 64); }              \
  else if (bm == 128 && bn == 32) { LAUNCH(T, 128, 32); }         \
  else if (bm == 64 && bn == 64) { LAUNCH(T, 64, 64); }           \
  else if (bm == 64 && bn == 32) { LAUNCH(T, 64, 32); }           \
  else if (bm == 32 && bn == 64) { LAUNCH(T, 32, 64); }           \
  else if (bm == 32 && bn == 32) { LAUNCH(T, 32, 32); }           \
  else { return static_cast<int>(cudaErrorInvalidValue); }
