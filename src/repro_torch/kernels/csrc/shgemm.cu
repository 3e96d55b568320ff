// Kernel 1: SHGEMM with Omega materialized.  C_f32 = A_f32 @ B_lowp.
//
// Replaces the Pallas TPU kernel `_shgemm_kernel`
// (repro/kernels/shgemm.py, entry `shgemm_pallas`).
//
// What bounds it on an H100: bytes.  At the rSVD shape (4096x4096 @ 4096x266,
// 2 terms) it must move ~70.6 MB (A 64 MB dominates) against ~17.9 GFLOP of
// bf16 tensor-core work, ~21 us vs ~18 us at the data-sheet peaks.  The
// design keeps A's bytes to one pass per output-column tile: blockIdx.x runs
// over N, so the few blocks sharing an A row panel are co-resident and meet
// in L2; the hi/lo split happens in registers, costing no device-memory
// bytes; the next stage's global loads are issued before the current stage's
// MMAs.  No split-K: shapes with few output tiles (RP-HOSVD's 256 x 32) fill
// few SMs.
#include "shgemm_common.cuh"

namespace {

// B (K, N) row-major 16-bit -> transposed (BN, BKS) shared stage.
template <int BM, int BN>
struct LoadB {
  static constexpr int NT = shg::Tile<BM, BN>::THREADS;
  static constexpr int VECS = shg::BKS * BN / 8;  // uint4 per stage
  static_assert(VECS % NT == 0, "B stage must split evenly");
  static constexpr int PER = VECS / NT;
  const uint16_t* B;
  int N, n0;
  uint4 reg[PER];

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      reg[j] = *reinterpret_cast<const uint4*>(
          B + static_cast<size_t>(k0 + r) * N + n0 + c);
    }
  }
  __device__ __forceinline__ void store(uint16_t* Bs, int) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&reg[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[(c + e) * shg::B_STRIDE + r] = h[e];
    }
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(shg::Tile<BM, BN>::THREADS)
    shgemm_kernel(const float* __restrict__ A, const uint16_t* __restrict__ B,
                  float* __restrict__ C, int N, int K, int bk, int terms) {
  LoadB<BM, BN> prod{B, N, static_cast<int>(blockIdx.x) * BN};
  shg::shgemm_mainloop<T, BM, BN>(A, C, N, K, bk, terms, prod);
}

}  // namespace

#define SHG_LAUNCH(T, BM_, BN_)                                             \
  shgemm_kernel<T, BM_, BN_>                                                \
      <<<dim3(N / BN_, M / BM_), shg::Tile<BM_, BN_>::THREADS, 0, stream>>>( \
          static_cast<const float*>(A), static_cast<const uint16_t*>(B),    \
          static_cast<float*>(C), N, K, bk, terms)

// Launches on `stream` of device `device`, does not synchronise, allocates
// nothing.  Returns cudaGetLastError() (0 on success).
extern "C" int shgemm_launch(const void* A, const void* B, void* C, int M,
                             int N, int K, int bm, int bn, int bk, int terms,
                             int b_fp16, void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (terms < 1 || terms > 3 || (terms == 3 && b_fp16) || bk % shg::BKS ||
      M % bm || N % bn || K % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  SHG_DISPATCH(bm, bn, b_fp16, SHG_LAUNCH);
  return static_cast<int>(cudaGetLastError());
}
