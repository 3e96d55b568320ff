// Kernel 2: fused RNG + SHGEMM.  C_f32 = A_f32 @ Omega(key)[K, N], with each
// (BKS, BN) Omega stage hashed into shared memory and never stored in device
// memory.
//
// Replaces the Pallas TPU kernel `_fused_kernel`
// (repro/kernels/shgemm_fused.py, entry `shgemm_fused_pallas`).
//
// What bounds it on an H100: bytes -- A read once and C written once, 67.1 MB
// at RP-HOSVD's 256 x 65536 @ . x 32 and 68.4 MB at rSVD's 4096 x 4096 @
// . x 266, ~20 us each at 3.35 TB/s; the two-term tensor work is 2.1 and
// 17.9 GFLOP (2 and 18 us at 989 TFLOP/s).  What it must beat besides is
// the Gaussian's ALU work (hashes, logf, sqrtf, cosf) and, at RP-HOSVD's
// single 256 x 32 output tile, the card's 132 SMs with one block's worth of
// output.  The design (main loop in shgemm_splitk.cuh):
//  - split-K: the grid's third axis cuts K into runs of whole bk tiles, so
//    the one output tile of RP-HOSVD fills the card; each tile's partial
//    product goes to a workspace and splitk_reduce sums them in tile order,
//    the order of the unsplit accumulator, so the bits do not change;
//  - Omega once per block: the 256 x 32 tile stacks eight warps on one
//    Omega stage, so each element is hashed once for every 256 rows of A
//    (once on the card at RP-HOSVD), and GenOmega hoists the row hash (once
//    a stage) and the column hashes (once a block) out of the element, which
//    then costs one fmix32 per stream; the next stage is generated into a
//    second buffer while this one is multiplied;
//  - A through a ring of RING stages filled by cp.async, so A's loads stay
//    in flight across stages with one barrier a stage.
//
// Omega element (r, c) of the launch is the lattice point
// (row_offset + r, col_offset + c); its value is rounded f32 -> store type
// (fp8 by RN, via cuda_fp8.h) -> the MMA's 16-bit type.  Built without
// --use_fast_math: logf/cosf/sqrtf must stay accurate.
#include <cuda_fp8.h>

#include "counter_hash.cuh"
#include "shgemm_splitk.cuh"

namespace {

enum StoreKind { kStoreLowp = 0, kStoreE4M3 = 1, kStoreE5M2 = 2 };

__device__ __forceinline__ float round_store(float v, int store_kind) {
  if (store_kind == kStoreLowp) return v;
  const __nv_fp8_interpretation_t fmt =
      store_kind == kStoreE4M3 ? __NV_E4M3 : __NV_E5M2;
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, fmt);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, fmt)));
}

// Each thread writes one row (k = lane) of PER columns of the stage.  Its
// row hash is computed once a stage and the columns' hashes once a block,
// into a table shared by the block (hc0 for stream 0, hc1 for stream 1), so
// an element costs one fmix32 per stream on top of the sample's own math.
template <typename T, int BM, int BN>
struct GenOmega {
  static constexpr int NT = shg::Tile<BM, BN>::THREADS;
  static_assert((shg::BKS * BN) % NT == 0 && NT % shg::BKS == 0,
                "Omega stage must split evenly, one row a lane");
  static constexpr int PER = shg::BKS * BN / NT;
  static constexpr int SMEM_WORDS = 2 * BN;
  uint32_t k0, k1, row_offset, col;  // col: lattice column of this block
  int dist, store_kind;
  float thr1, thr2;
  const uint32_t* hc;

  __device__ __forceinline__ void init(uint32_t* table) {
    for (int i = threadIdx.x; i < 2 * BN; i += NT)
      table[i] = shg::col_hash(k1, col + static_cast<uint32_t>(i % BN),
                               static_cast<uint32_t>(i / BN));
    hc = table;
  }

  __device__ __forceinline__ void fetch(int) {}  // nothing to read

  __device__ __forceinline__ void store(uint16_t* Bs, int kbase) {
    const int k = threadIdx.x % shg::BKS;
    const uint32_t hr =
        shg::row_hash(k0, row_offset + static_cast<uint32_t>(kbase + k));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int n = threadIdx.x / shg::BKS + j * (NT / shg::BKS);
      const float v = shg::sample(hr, hc[n], hc[BN + n], dist, thr1, thr2);
      Bs[n * shg::B_STRIDE + k] = shg::LowP<T>::round(round_store(v, store_kind));
    }
  }
};

template <typename T, int BM, int BN, int TERMS>
__global__ void __launch_bounds__(shg::Tile<BM, BN>::THREADS)
    shgemm_fused_kernel(const float* __restrict__ A, float* __restrict__ out,
                        int M, int N, int K, int bk, uint32_t k0, uint32_t k1,
                        uint32_t row_offset, uint32_t col_offset, int dist,
                        int store_kind, float thr1, float thr2) {
  extern __shared__ __align__(16) unsigned char smem[];
  GenOmega<T, BM, BN> prod{k0, k1, row_offset,
                           col_offset + static_cast<uint32_t>(blockIdx.x) * BN,
                           dist, store_kind, thr1, thr2, nullptr};
  shg::splitk_mainloop<T, BM, BN, TERMS>(A, out, M, N, K, bk, prod, smem);
}

struct Launch {
  const float* A;
  float* C;
  float* W;
  int M, N, K, bk, splits;
  uint32_t k0, k1, row_offset, col_offset;
  int dist, store_kind;
  float thr1, thr2;
  cudaStream_t stream;

  template <typename T, int BM, int BN, int TERMS>
  int run() const {
    constexpr int smem = shg::SplitKSmem<BM, BN>::BYTES +
                         GenOmega<T, BM, BN>::SMEM_WORDS * 4;
    return shg::launch_splitk<BM, BN>(
        shgemm_fused_kernel<T, BM, BN, TERMS>, smem, A, C, W, M, N, K, bk,
        splits, stream, k0, k1, row_offset, col_offset, dist, store_kind, thr1,
        thr2);
  }
};

}  // namespace

// dist: 0 gaussian, 1 sign (achlioptas / very_sparse, thresholds thr1 < thr2).
// store_kind: 0 the MMA type itself, 1 fp8 e4m3, 2 fp8 e5m2 (then lowp_fp16
// must be 0: fp8 is consumed as bf16).  splits > 1 needs the workspace W of
// (K / bk) * M * N floats; W is unused with splits == 1.  Launches on
// `stream` of device `device`, does not synchronise, allocates nothing.
// Returns the first CUDA error (0 on success).
extern "C" int shgemm_fused_launch(const void* A, void* C, void* W, int M,
                                   int N, int K, uint32_t k0, uint32_t k1,
                                   uint32_t row_offset, uint32_t col_offset,
                                   int bm, int bn, int bk, int splits,
                                   int terms, int lowp_fp16, int store_kind,
                                   int dist, float thr1, float thr2,
                                   void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (!shg::valid_plan(M, N, K, bm, bn, bk, splits, terms, lowp_fp16, W) ||
      dist < 0 || dist > 1 || store_kind < 0 || store_kind > 2 ||
      (store_kind != kStoreLowp && lowp_fp16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch launch{static_cast<const float*>(A), static_cast<float*>(C),
                      static_cast<float*>(W), M, N, K, bk, splits, k0, k1,
                      row_offset, col_offset, dist, store_kind, thr1, thr2,
                      static_cast<cudaStream_t>(stream_ptr)};
  return shg::dispatch(bm, bn, lowp_fp16, terms, launch);
}
