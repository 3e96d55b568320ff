// Split-K main loop of the split-precision GEMM shared by kernel 1
// (shgemm.cu, B read from device memory) and kernel 2 (shgemm_fused.cu, B
// hashed on chip): out = A_f32[M, K] @ B_lowp[K, N], B in bf16 or fp16,
// produced stage by stage into shared memory.
//
// Numerics.  A stage is BKS = 32 deep: the f32 A tile and the 16-bit B tile
// sit in shared memory, B transposed to (n, k) so a B fragment is one 32-bit
// load.  A fragments are split in registers into `TERMS` low-precision parts
// (paper Eq. 37-38; fp16 scales the residual by 2^11 and the correction
// product by 2^-11), one mma.sync m16n8k16 per term, each term into its own
// f32 partial, so the tensor cores' own accumulation is confined to one bk
// tile (the Pallas body `acc = 0; acc += term; acc_ref += acc`).
//
// The grid is (N / BN, M / BM, S).  Split z owns the contiguous run of
// K / bk / S whole bk tiles starting at tile z * K / bk / S.  At each tile's
// end the partials are summed T_j = (P0 + P1 s) + P2.  With S = 1 the block
// adds T_j into its accumulator, acc = ((0 + T_0) + T_1) + ..., and writes
// C; with S > 1 it writes T_j to the workspace W[j, M, N] and splitk_reduce
// sums W in j order from 0.  Either way every output element is the same
// chain of RN f32 adds over the same T_j, so the bits depend on bk alone,
// never on BM, BN or S, and kernels 1 and 2 agree bit for bit on one B.
//
// Each warp owns a 32x32 sub-tile (2 x 4 MMA tiles), and the block
// (Tile<BM, BN>::THREADS threads) shares one B stage: at BM = 256, BN = 32
// eight warps stacked along M consume each B element produced once.
//
// The caller guarantees M % BM == 0, N % BN == 0, K % bk == 0,
// bk % BKS == 0, (K / bk) % S == 0, 16-byte-aligned A (and B), and
// contiguous row-major layouts (`valid_plan` checks the numbers).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace shg {

constexpr int BKS = 32;            // K depth of one shared-memory stage
constexpr int A_STRIDE = BKS + 8;  // floats; conflict-free float2 reads
constexpr int B_STRIDE = BKS + 8;  // 16-bit words; conflict-free 32-bit reads

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

// A stages in flight: the ring holds RING stages, RING - 1 of them loading
// while one is consumed.
constexpr int RING = 3;

// Dynamic shared memory of one block: the ring of RING f32 A stages, two B
// stages, then the producer's own table of `Producer::SMEM_WORDS` 32-bit
// words.  At BM = 256 a stage is 40 KB.
template <int BM, int BN>
struct SplitKSmem {
  static constexpr int A_FLOATS = BM * A_STRIDE;
  static constexpr int B_HALVES = BN * B_STRIDE;
  static constexpr int BYTES = RING * A_FLOATS * 4 + 2 * B_HALVES * 2;
};

// 16-byte asynchronous copy global -> shared (L2 only: A is read once).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `Producer` fills the (BN, BKS) transposed B stage:
//   prod.init(table) -- once per block, before the first stage (the loop
//                       synchronises the block after it);
//   prod.fetch(k0)   -- start reading the stage at global K index k0 (into
//                       registers; a no-op for a producer that computes B).
//                       Stage s + 1 is fetched before stage s's MMAs, so the
//                       loads fly while they run;
//   prod.store(Bs, k0) -- write the stage at k0, fetched before.  Stage
//                       s + 1 is written after stage s's MMAs, into the
//                       other of the two B buffers.
template <typename T, int BM, int BN, int TERMS, class Producer>
__device__ __forceinline__ void splitk_mainloop(const float* __restrict__ A,
                                                float* __restrict__ out, int M,
                                                int N, int K, int bk,
                                                Producer& prod,
                                                unsigned char* smem) {
  constexpr int NT = Tile<BM, BN>::THREADS;
  constexpr int WN = Tile<BM, BN>::WARPS_N;
  constexpr int A_VECS = BM * BKS / 4;  // float4 per A stage
  static_assert(A_VECS % NT == 0, "A stage must split evenly");
  constexpr int A_PER = A_VECS / NT;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  static_assert(TERMS >= 1 && TERMS <= 3 && !(kFp16 && TERMS == 3),
                "terms: 1-3 for bf16, 1-2 for fp16");

  constexpr int A_FLOATS = SplitKSmem<BM, BN>::A_FLOATS;
  constexpr int B_HALVES = SplitKSmem<BM, BN>::B_HALVES;
  float* As = reinterpret_cast<float*>(smem);
  uint16_t* Bs = reinterpret_cast<uint16_t*>(As + RING * A_FLOATS);
  prod.init(reinterpret_cast<uint32_t*>(Bs + 2 * B_HALVES));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tiles = (K / bk) / gridDim.z;  // bk tiles of this split
  const int tile0 = blockIdx.z * tiles;
  const int kbeg = tile0 * bk;
  const bool direct = gridDim.z == 1;

  float acc[2][4][4];
  float part[TERMS][2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // Stage s of this split into ring slot s % RING, by cp.async: global to
  // shared memory without staging through registers.
  const float* a_blk = A + static_cast<size_t>(m0) * K + kbeg;
  auto load_a = [&](int s) {
    float* dst = As + (s % RING) * A_FLOATS;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / (BKS / 4), c = (idx % (BKS / 4)) * 4;
      cp_async16(dst + r * A_STRIDE + c,
                 a_blk + static_cast<size_t>(r) * K + s * BKS + c);
    }
  };

  const int per_tile = bk / BKS;
  const int nstages = tiles * per_tile;
  __syncthreads();  // the producer's table
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {  // one group a stage, empty or not
    if (s < nstages) load_a(s);
    cp_async_commit();
  }
  prod.fetch(kbeg);
  prod.store(Bs, kbeg);
  for (int s = 0; s < nstages; ++s) {
    // One barrier a stage: this thread's copies of stage s have landed
    // (RING - 2 younger groups may still fly), the barrier makes every
    // thread's copies and the B stage visible, and every warp is done with
    // stage s - 1, whose A slot and B buffer the writes below refill.
    cp_async_wait<RING - 2>();
    __syncthreads();
    const int k0 = kbeg + s * BKS;
    const float* as = As + (s % RING) * A_FLOATS;
    const uint16_t* bs = Bs + (s & 1) * B_HALVES;
    if (s + RING - 1 < nstages) load_a(s + RING - 1);
    cp_async_commit();
    if (s + 1 < nstages) prod.fetch(k0 + BKS);
    if (s % per_tile == 0) {
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[t][i][j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < BKS; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* p = bs + (wn * 32 + nt * 8 + g) * B_STRIDE + kk + 2 * t4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* pa = as + (wm * 32 + mt * 16 + g) * A_STRIDE + kk + 2 * t4;
        const float2 v0 = *reinterpret_cast<const float2*>(pa);
        const float2 v1 = *reinterpret_cast<const float2*>(pa + 8 * A_STRIDE);
        const float2 v2 = *reinterpret_cast<const float2*>(pa + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(pa + 8 * A_STRIDE + 8);
        float r[8] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y, v3.x, v3.y};
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
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
    // The next B stage: this warp's stores (or ALU work) overlap the other
    // warps' MMAs of this stage.
    if (s + 1 < nstages) prod.store(Bs + ((s + 1) & 1) * B_HALVES, k0 + BKS);
    if ((s + 1) % per_tile == 0) {  // bk boundary: T_j, fixed order
      float* wj = out + static_cast<size_t>(tile0 + s / per_tile) * M * N;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float tile[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tile[e] = part[0][i][j][e];
            if (TERMS > 1) tile[e] = tile[e] + (kFp16 ? part[1 % TERMS][i][j][e] * 0x1p-11f
                                                      : part[1 % TERMS][i][j][e]);
            if (TERMS > 2) tile[e] = tile[e] + part[2 % TERMS][i][j][e];
            acc[i][j][e] = acc[i][j][e] + tile[e];
          }
          if (!direct) {
            const int row = m0 + wm * 32 + i * 16 + g;
            const int col = n0 + wn * 32 + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(wj + static_cast<size_t>(row) * N + col) =
                make_float2(tile[0], tile[1]);
            *reinterpret_cast<float2*>(wj + static_cast<size_t>(row + 8) * N + col) =
                make_float2(tile[2], tile[3]);
          }
        }
    }
  }

  if (!direct) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * 32 + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// C[i] = ((0 + W[0][i]) + W[1][i]) + ... + W[J-1][i], i over M * N: the
// fixed-order chain of the direct path.  The loads of a chunk are issued
// before its adds, so they are in flight together.
constexpr int REDUCE_THREADS = 128;
constexpr int REDUCE_UNROLL = 16;

__global__ void __launch_bounds__(REDUCE_THREADS)
    splitk_reduce(const float* __restrict__ W, float* __restrict__ C,
                  long long mn, int J) {
  const long long i = static_cast<long long>(blockIdx.x) * REDUCE_THREADS + threadIdx.x;
  if (i >= mn) return;
  const float* p = W + i;
  float acc = 0.0f;
  int j = 0;
  for (; j + REDUCE_UNROLL <= J; j += REDUCE_UNROLL) {
    float v[REDUCE_UNROLL];
#pragma unroll
    for (int u = 0; u < REDUCE_UNROLL; ++u) v[u] = __ldcg(p + (j + u) * mn);
#pragma unroll
    for (int u = 0; u < REDUCE_UNROLL; ++u) acc = acc + v[u];
  }
  for (; j < J; ++j) acc = acc + __ldcg(p + j * mn);
  C[i] = acc;
}

// Whether (bm, bn, bk, splits, terms) is a launchable plan for the launch
// shape (M, N, K); W is needed with more than one split.
inline bool valid_plan(int M, int N, int K, int bm, int bn, int bk, int splits,
                       int terms, int fp16, const void* W) {
  return terms >= 1 && terms <= 3 && !(terms == 3 && fp16) && bk > 0 &&
         bk % BKS == 0 && bm > 0 && bn > 0 && M % bm == 0 && N % bn == 0 &&
         K % bk == 0 && splits >= 1 && splits <= 65535 &&
         (K / bk) % splits == 0 && (splits == 1 || W != nullptr);
}

// Launches `kernel(A, out, M, N, K, bk, extra...)` on the (N / BN, M / BM,
// splits) grid with `smem` bytes of dynamic shared memory, out = C with one
// split and the workspace W (K / bk tiles of M x N floats) with more, then
// splitk_reduce W -> C.  Returns the first CUDA error (0 on success).
template <int BM, int BN, typename... P, typename... X>
int launch_splitk(void (*kernel)(const float*, float*, int, int, int, int, P...),
                  int smem, const float* A, float* C, float* W, int M, int N,
                  int K, int bk, int splits, cudaStream_t stream, X... extra) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(N / BN, M / BM, splits), Tile<BM, BN>::THREADS, smem, stream>>>(
      A, splits == 1 ? C : W, M, N, K, bk, extra...);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + REDUCE_THREADS - 1) / REDUCE_THREADS),
                  REDUCE_THREADS, 0, stream>>>(W, C, mn, K / bk);
  return static_cast<int>(cudaGetLastError());
}

// Calls f.template run<T, BM, BN, TERMS>() for the runtime tile (bm, bn),
// 16-bit type and term count.  The tiles are the Python side's TILES
// (kernels/shgemm.py); terms 1-3 for bf16, 1-2 for fp16.
template <typename T, int BM, int BN, class F>
int dispatch_terms(int terms, const F& f) {
  if (terms == 1) return f.template run<T, BM, BN, 1>();
  if (terms == 2) return f.template run<T, BM, BN, 2>();
  if constexpr (!std::is_same<T, __half>::value) {
    if (terms == 3) return f.template run<T, BM, BN, 3>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, class F>
int dispatch_tile(int bm, int bn, int terms, const F& f) {
  if (bm == 256 && bn == 32) return dispatch_terms<T, 256, 32>(terms, f);
  if (bm == 128 && bn == 64) return dispatch_terms<T, 128, 64>(terms, f);
  if (bm == 128 && bn == 32) return dispatch_terms<T, 128, 32>(terms, f);
  if (bm == 64 && bn == 64) return dispatch_terms<T, 64, 64>(terms, f);
  if (bm == 64 && bn == 32) return dispatch_terms<T, 64, 32>(terms, f);
  if (bm == 32 && bn == 64) return dispatch_terms<T, 32, 64>(terms, f);
  if (bm == 32 && bn == 32) return dispatch_terms<T, 32, 32>(terms, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class F>
int dispatch(int bm, int bn, int fp16, int terms, const F& f) {
  return fp16 ? dispatch_tile<__half>(bm, bn, terms, f)
              : dispatch_tile<__nv_bfloat16>(bm, bn, terms, f);
}

}  // namespace shg
