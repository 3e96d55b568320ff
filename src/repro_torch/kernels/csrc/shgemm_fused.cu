// Kernel 2: fused RNG + SHGEMM.  C_f32 = A_f32 @ Omega(key)[K, N], with each
// (BKS, BN) Omega stage hashed into shared memory and never stored in device
// memory.
//
// Replaces the Pallas TPU kernel `_fused_kernel`
// (repro/kernels/shgemm_fused.py, entry `shgemm_fused_pallas`).
//
// What bounds it on an H100: by bytes, A reads plus C writes only
// (`hbm_bytes_modeled`), ~68.4 MB or ~20 us at the rSVD shape.  The hash and
// Box-Muller cost ALU work instead: each output row panel regenerates the
// Omega tiles it needs, so the generation is repeated M / BM times, and for
// the Gaussian (two hashes, logf, sqrtf, cosf per element) that ALU work,
// not the bytes, is expected to set the time.  The design keeps the bytes at
// the bound and leaves cutting the regeneration (larger BM, or tiles shared
// across a cluster) to later work.
//
// Omega element (r, c) of the launch is the lattice point
// (row_offset + r, col_offset + c); its value is rounded f32 -> store type
// (fp8 by RN, via cuda_fp8.h) -> the MMA's 16-bit type.  Built without
// --use_fast_math: logf/cosf/sqrtf must stay accurate.
#include <cuda_fp8.h>

#include "counter_hash.cuh"
#include "shgemm_common.cuh"

namespace {

enum StoreKind { kStoreLowp = 0, kStoreE4M3 = 1, kStoreE5M2 = 2 };

__device__ __forceinline__ float round_store(float v, int store_kind) {
  if (store_kind == kStoreLowp) return v;
  const __nv_fp8_interpretation_t fmt =
      store_kind == kStoreE4M3 ? __NV_E4M3 : __NV_E5M2;
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, fmt);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, fmt)));
}

template <typename T, int BM, int BN>
struct GenB {
  static constexpr int NT = shg::Tile<BM, BN>::THREADS;
  static_assert((shg::BKS * BN) % NT == 0, "Omega stage must split evenly");
  static constexpr int PER = shg::BKS * BN / NT;
  uint32_t k0, k1, row_offset, col;  // col: lattice column of this block
  int dist, store_kind;
  float thr1, thr2;

  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ void store(uint16_t* Bs, int kbase) {
#pragma unroll 4
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      const int n = idx / shg::BKS, k = idx % shg::BKS;
      const uint32_t row = row_offset + static_cast<uint32_t>(kbase + k);
      float v = shg::sample(k0, k1, row, col + static_cast<uint32_t>(n), dist,
                            thr1, thr2);
      Bs[n * shg::B_STRIDE + k] = shg::LowP<T>::round(round_store(v, store_kind));
    }
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(shg::Tile<BM, BN>::THREADS)
    shgemm_fused_kernel(const float* __restrict__ A, float* __restrict__ C,
                        int N, int K, int bk, int terms, uint32_t k0,
                        uint32_t k1, uint32_t row_offset, uint32_t col_offset,
                        int dist, int store_kind, float thr1, float thr2) {
  GenB<T, BM, BN> prod{k0, k1, row_offset,
                       col_offset + static_cast<uint32_t>(blockIdx.x) * BN,
                       dist, store_kind, thr1, thr2};
  shg::shgemm_mainloop<T, BM, BN>(A, C, N, K, bk, terms, prod);
}

}  // namespace

#define SHG_LAUNCH(T, BM_, BN_)                                              \
  shgemm_fused_kernel<T, BM_, BN_>                                           \
      <<<dim3(N / BN_, M / BM_), shg::Tile<BM_, BN_>::THREADS, 0, stream>>>( \
          static_cast<const float*>(A), static_cast<float*>(C), N, K, bk,    \
          terms, k0, k1, row_offset, col_offset, dist, store_kind, thr1, thr2)

// dist: 0 gaussian, 1 sign (achlioptas / very_sparse, thresholds thr1 < thr2).
// store_kind: 0 the MMA type itself, 1 fp8 e4m3, 2 fp8 e5m2 (then lowp_fp16
// must be 0: fp8 is consumed as bf16).  Returns cudaGetLastError().
extern "C" int shgemm_fused_launch(const void* A, void* C, int M, int N, int K,
                                   uint32_t k0, uint32_t k1,
                                   uint32_t row_offset, uint32_t col_offset,
                                   int bm, int bn, int bk, int terms,
                                   int lowp_fp16, int store_kind, int dist,
                                   float thr1, float thr2, void* stream_ptr,
                                   int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (terms < 1 || terms > 3 || (terms == 3 && lowp_fp16) || bk % shg::BKS ||
      M % bm || N % bn || K % bk || dist < 0 || dist > 1 || store_kind < 0 ||
      store_kind > 2 || (store_kind != kStoreLowp && lowp_fp16))
    return static_cast<int>(cudaErrorInvalidValue);
  SHG_DISPATCH(bm, bn, lowp_fp16, SHG_LAUNCH);
  return static_cast<int>(cudaGetLastError());
}
