// Kernel 1: SHGEMM with Omega materialized.  C_f32 = A_f32 @ B_lowp.
//
// Replaces the Pallas TPU kernel `_shgemm_kernel`
// (repro/kernels/shgemm.py, entry `shgemm_pallas`).
//
// What bounds it on an H100: bytes.  At the rSVD shape (4096x4096 @ 4096x266,
// 2 terms) it must move ~70.6 MB (A 64 MB dominates) against ~17.9 GFLOP of
// bf16 tensor-core work, ~21 us vs ~18 us at the data-sheet peaks; at
// RP-HOSVD's 256 x 65536 @ . x 32, 71.3 MB (A 64 MB, B 4 MB) against 2.1
// GFLOP.  The design is kernel 2's main loop (shgemm_splitk.cuh) with a B
// producer that reads B from device memory:
//  - split-K: the grid's third axis cuts K into runs of whole bk tiles, so
//    RP-HOSVD's one 256 x 32 output tile fills the card, and a fixed-order
//    reduction keeps the bits a function of bk alone (equal to kernel 2's on
//    the same B);
//  - A through the loop's ring of cp.async stages; the hi/lo split happens
//    in registers, costing no device-memory bytes;
//  - B route: LoadB reads stage s + 1 into registers (`fetch`, 16 bytes a
//    thread) before stage s's MMAs and writes it transposed into the
//    loop's second B buffer (`store`) after them.  The transposed (n, k)
//    stage keeps the loop's B fragment reads -- one 32-bit load each,
//    shared with kernel 2 -- unchanged; a row-major stage would need
//    ldmatrix.trans or two 16-bit loads a fragment word there.  A thread
//    reads one 8-column run of one k row, and the 32 lanes of a warp take
//    32 consecutive k rows, so the eight 16-bit transposed stores of a run
//    fall on 16 distinct banks (two lanes to a word): conflict-free.
#include "shgemm_splitk.cuh"

namespace {

// B (K, N) row-major 16-bit -> the transposed (BN, BKS) shared stage.
template <int BM, int BN>
struct LoadB {
  static constexpr int NT = shg::Tile<BM, BN>::THREADS;
  static constexpr int VECS = shg::BKS * BN / 8;  // uint4 per stage
  static constexpr int PER = (VECS + NT - 1) / NT;
  static_assert(VECS % NT == 0 || NT % VECS == 0, "B stage must split evenly");
  static constexpr int SMEM_WORDS = 0;
  const uint16_t* B;
  int N, n0;
  uint4 reg[PER];

  __device__ __forceinline__ void init(uint32_t*) {}

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (VECS >= NT || idx < VECS) {
        const int r = idx % shg::BKS, c = (idx / shg::BKS) * 8;
        reg[j] = *reinterpret_cast<const uint4*>(
            B + static_cast<size_t>(k0 + r) * N + n0 + c);
      }
    }
  }

  __device__ __forceinline__ void store(uint16_t* Bs, int) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (VECS >= NT || idx < VECS) {
        const int r = idx % shg::BKS, c = (idx / shg::BKS) * 8;
        const uint16_t* h = reinterpret_cast<const uint16_t*>(&reg[j]);
#pragma unroll
        for (int e = 0; e < 8; ++e) Bs[(c + e) * shg::B_STRIDE + r] = h[e];
      }
    }
  }
};

template <typename T, int BM, int BN, int TERMS>
__global__ void __launch_bounds__(shg::Tile<BM, BN>::THREADS)
    shgemm_kernel(const float* __restrict__ A, float* __restrict__ out, int M,
                  int N, int K, int bk, const uint16_t* __restrict__ B) {
  extern __shared__ __align__(16) unsigned char smem[];
  LoadB<BM, BN> prod{B, N, static_cast<int>(blockIdx.x) * BN, {}};
  shg::splitk_mainloop<T, BM, BN, TERMS>(A, out, M, N, K, bk, prod, smem);
}

struct Launch {
  const float* A;
  const uint16_t* B;
  float* C;
  float* W;
  int M, N, K, bk, splits;
  cudaStream_t stream;

  template <typename T, int BM, int BN, int TERMS>
  int run() const {
    return shg::launch_splitk<BM, BN>(shgemm_kernel<T, BM, BN, TERMS>,
                                      shg::SplitKSmem<BM, BN>::BYTES, A, C, W,
                                      M, N, K, bk, splits, stream, B);
  }
};

// Writes to `blocks` how many blocks of one instantiation an SM holds at
// once (the CUDA occupancy calculator); returns the first CUDA error.
struct Occupancy {
  int* blocks;

  template <typename T, int BM, int BN, int TERMS>
  int run() const {
    auto kernel = shgemm_kernel<T, BM, BN, TERMS>;
    constexpr int smem = shg::SplitKSmem<BM, BN>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, shg::Tile<BM, BN>::THREADS, smem);
    return static_cast<int>(err);
  }
};

}  // namespace

// splits > 1 needs the workspace W of (K / bk) * M * N floats; W is unused
// with splits == 1.  Launches on `stream` of device `device`, does not
// synchronise, allocates nothing.  Returns the first CUDA error (0 on
// success).
extern "C" int shgemm_launch(const void* A, const void* B, void* C, void* W,
                             int M, int N, int K, int bm, int bn, int bk,
                             int splits, int terms, int b_fp16,
                             void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (!shg::valid_plan(M, N, K, bm, bn, bk, splits, terms, b_fp16, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch launch{static_cast<const float*>(A), static_cast<const uint16_t*>(B),
                      static_cast<float*>(C), static_cast<float*>(W), M, N, K, bk,
                      splits, static_cast<cudaStream_t>(stream_ptr)};
  return shg::dispatch(bm, bn, b_fp16, terms, launch);
}

// Blocks of the (bm, bn, terms) instantiation an SM of `device` holds at
// once; -1 for a plan the kernel does not instantiate or on a CUDA error.
extern "C" int shgemm_blocks_per_sm(int bm, int bn, int terms, int b_fp16,
                                    int device) {
  int blocks = -1;
  if (cudaSetDevice(device) != cudaSuccess ||
      shg::dispatch(bm, bn, b_fp16, terms, Occupancy{&blocks}) != 0)
    return -1;
  return blocks;
}
