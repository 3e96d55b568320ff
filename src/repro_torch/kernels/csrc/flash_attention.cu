// Kernel 3: causal GQA flash attention with a blockwise online softmax.
//   out[b, s, h, :] = softmax_j(q[b, s, h] . k[b, j, h/G] * scale) v[b, j, h/G]
// over j <= s (causal) or all j < S, with G = H / KV query heads per kv head.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (repro/kernels/flash_attention.py, entry `flash_attention`).
//
// What bounds it on an H100: operations.  At the prefill shape
// (1 x 32768 x 16 heads x 128, causal) the two products are ~4.4 TFLOP of
// bf16 tensor-core work a layer (4.4 ms at 989 TFLOP/s) against 0.3 GB of
// q/k/v/out (0.1 ms at 3.35 TB/s).  The design:
//  * one block per (q block, batch * kv head), carrying all G query heads of
//    its group (bq = 16 * floor(8 / G) positions of each, G * bq <= 128
//    live rows: 128 at G = 1, 2, 4, 8; 112 at G = 7), so each K/V tile is
//    read from device memory once for the G heads; the (S, S) score matrix
//    never exists.  Rows from G * bq up to 128 (a whole m16 tile each) are
//    zero-filled, never loaded from another group's heads and never
//    stored: a second instantiation (kDead) carries those checks, so the
//    G that divide 8 run the kernel without them, its registers unchanged;
//  * four warps of two m16 tiles (32 query rows) each: every K or V fragment
//    loaded feeds two MMAs, which halves the shared-memory reads per MMA
//    against one tile a warp, and two blocks share an SM (up to 255
//    registers a thread, 68 KB of shared memory a block at hd 128), so one
//    block's softmax overlaps the other's MMAs.  Tiles are BKV = 32 keys:
//    the accumulator takes 128 registers a thread and the scores 32; 64-key
//    tiles would need 32 more and spill;
//  * the kv loop runs inside the block, only up to the causal diagonal:
//    blocks above it issue no loads and no MMA (the TPU kernel's skipped
//    grid steps); q blocks are issued heaviest first;
//  * the block's Q tile is copied to shared memory once; K and V tiles
//    stream through a STAGES-deep ring behind it, all by cp.async (16 bytes
//    a thread, zero-filled past S), in their row-major layout with padded
//    rows, so tile j + 1 loads while tile j is multiplied, with one barrier
//    a tile;
//  * bf16 fragments come from shared memory by ldmatrix: Q's and K's as
//    they lie (ldmatrix.x4, two k-steps of K a load), V's by
//    ldmatrix.x4.trans (two output n-tiles of P.V a load), so V is never
//    transposed in memory.  The padded 272-byte rows put the eight 16-byte
//    rows of each 8 x 8 matrix on distinct banks;
//  * q, k, v are read in their native (B, S, heads, hd) layout by strides,
//    with no transposing copy;
//  * Q.K^T and P.V run on mma.sync m16n8k16 with f32 accumulation; P stays
//    in registers between the two (the S accumulator fragment is P's A
//    fragment).  m, l and the output accumulator live in registers;
//  * the causal and ragged mask runs only on the tiles that cross a warp's
//    diagonal or the sequence end; the softmax is exp2f of one FMA,
//    s * scale * log2(e) - m * scale * log2(e), which takes scale > 0 (the
//    wrapper negates q for a negative scale and zeroes it for scale 0);
//  * bf16 inputs: Q.K^T is exact in f32 (bf16 x bf16 products); P is
//    rounded to bf16 for P.V.  f32 inputs run the same tiles in f32
//    and split every operand into bf16 hi + lo (the paper's split) as its
//    fragments are read: each product is hi.hi + hi.lo + lo.hi, which keeps
//    the result within ~1e-5 of f32 attention.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 2;                   // m16 tiles of query rows per warp
constexpr int ROWS = WARPS * MT * 16;   // query rows (all G heads) per block
constexpr int STAGES = 2;               // K/V tiles in the ring
constexpr int BKV = 32;                 // keys per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared; `bytes` = 0 zero-fills it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two f32 values as a bf16x2 word (x in the low half), RN.
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi), for a pair.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack(x - __low2float(h), y - __high2float(h));
}

// Element traits: the bf16 path reads words as they are, the f32 path
// splits each pair into hi and lo words.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kSplit = false;
  static __device__ __forceinline__ void pair(const __nv_bfloat16* p,
                                              uint32_t& hi, uint32_t&) {
    hi = *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<uint32_t*>(p) = pack(x, y);
  }
};

template <>
struct Elem<float> {
  static constexpr bool kSplit = true;
  static __device__ __forceinline__ void pair(const float* p, uint32_t& hi,
                                              uint32_t& lo) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    split2(v.x, v.y, hi, lo);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// Shared memory: the block's Q tile (ROWS rows), then the ring of STAGES
// slots of a K tile and a V tile (BKV rows each); every row holds HD
// elements padded by 8 (16 bytes in bf16: conflict-free ldmatrix rows; 32
// in f32: conflict-free float2 reads).
template <typename T, int HD>
struct Smem {
  static constexpr int STR = HD + 8;  // row stride, elements
  static constexpr int TILE = BKV * STR;
  static constexpr int QTILE = ROWS * STR;
  static constexpr int BYTES = (QTILE + STAGES * 2 * TILE) * sizeof(T);
};

template <typename T, int HD, bool kDead>
__global__ void __launch_bounds__(THREADS, 2)
    flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, T* __restrict__ O, int S, int H,
                 int KV, int G, int causal, float scale) {
  using E = Elem<T>;
  constexpr int STR = Smem<T, HD>::STR;
  constexpr int TILE = Smem<T, HD>::TILE;
  constexpr int NT = BKV / 8;      // score n-tiles per kv tile
  constexpr int KSTEPS = HD / 16;  // k-steps of Q.K^T
  constexpr int DT = HD / 8;       // output n-tiles
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int CPR = HD / EPC;                           // chunks a row
  constexpr int KV_CHUNKS = 2 * BKV * CPR;                // K and V tiles
  static_assert(KV_CHUNKS % THREADS == 0 && (ROWS * CPR) % THREADS == 0,
                "tiles must split evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + Smem<T, HD>::QTILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // query rows per head, and the live block rows (all of them unless kDead)
  const int bq = kDead ? 16 * (ROWS / 16 / G) : ROWS / G;
  const int live = kDead ? G * bq : ROWS;
  const int nq = (S + bq - 1) / bq;
  const int iq = causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const float sl2 = scale * LOG2E;

  // Block row r < live is position iq * bq + r % bq of head kvh * G + r /
  // bq; this warp owns rows (warp * MT + i) * 16 + [0, 16), one head each
  // (bq is a multiple of 16), or none where the tile is past `live`.
  int head[MT], pos0[MT];
  bool lives[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = (warp * MT + i) * 16;
    lives[i] = !kDead || row < live;
    head[i] = kvh * G + row / bq;
    pos0[i] = iq * bq + row % bq;
  }
  const int warp_first = min(pos0[0], pos0[MT - 1]);
  const int warp_last = max(pos0[0], pos0[MT - 1]) + 15;

  const int q_last = min(iq * bq + bq - 1, S - 1);  // block's last position
  const int kv_end = causal ? q_last + 1 : S;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  const size_t kv_row = static_cast<size_t>(KV) * HD;  // stride of one s
  const T* kbase = K + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const T* vbase = V + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  // Tile j into ring slot j % STAGES: K rows then V rows, zero past S.
  auto load_tile = [&](int j) {
    T* slot = ring + (j % STAGES) * 2 * TILE;
    const int kv0 = j * BKV;
#pragma unroll
    for (int i = 0; i < KV_CHUNKS / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int isv = idx >= KV_CHUNKS / 2;
      const int c = idx - isv * (KV_CHUNKS / 2);
      const int key = c / CPR, col = (c % CPR) * EPC;
      const int gk = kv0 + key;
      const T* src = (isv ? vbase : kbase) + static_cast<size_t>(min(gk, S - 1)) * kv_row + col;
      cp_async16(slot + isv * TILE + key * STR + col, src, gk < S ? 16 : 0);
    }
  };
  // The Q tile joins tile 0's group: one group a tile, empty or not.
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CPR, col = (idx % CPR) * EPC;
    const int pos = iq * bq + r % bq;
    const bool load = pos < S && (!kDead || r < live);
    const T* src = Q + ((static_cast<size_t>(b) * S + min(pos, S - 1)) * H +
                        kvh * G + (!kDead || r < live ? r / bq : 0)) * HD + col;
    cp_async16(qs + r * STR + col, src, load ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) load_tile(j);
    cp_async_commit();
  }

  float acc[MT][DT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][d][e] = 0.0f;
    m[i][0] = m[i][1] = NEG_INF;
    l[i][0] = l[i][1] = 0.0f;
  }
  // This warp's Q rows: A fragments by ldmatrix.x4 (bf16), lane l
  // addressing row l % 16, dims 8 * (l / 16) on; pairs by float2 (f32).
  const T* qw = qs + warp * MT * 16 * STR;
  const T* qlane = qw + (lane & 15) * STR + (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    // One barrier a tile: this thread's copies of tile j (and Q) have
    // landed, the barrier makes every thread's visible, and every warp is
    // done with tile j - 1, whose slot the load below refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
    cp_async_commit();
    const int kv0 = j * BKV;
    // A warp whose rows all sit above this tile (causal) has nothing to add.
    if (causal && kv0 > warp_last) continue;
    const T* Ks = ring + (j % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;

    float s[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][nt][e] = 0.0f;
    if constexpr (E::kSplit) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t qa[MT][4], ql[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const T* q = qw + (i * 16 + g) * STR + ks * 16 + 2 * t;
          E::pair(q, qa[i][0], ql[i][0]);
          E::pair(q + 8 * STR, qa[i][1], ql[i][1]);
          E::pair(q + 8, qa[i][2], ql[i][2]);
          E::pair(q + 8 * STR + 8, qa[i][3], ql[i][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* kr = Ks + (nt * 8 + g) * STR + ks * 16 + 2 * t;
          uint32_t b0, b1, b0l, b1l;
          E::pair(kr, b0, b0l);
          E::pair(kr + 8, b1, b1l);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(s[i][nt], qa[i], b0, b1);
            mma_bf16(s[i][nt], qa[i], b0l, b1l);
            mma_bf16(s[i][nt], ql[i], b0, b1);
          }
        }
      }
    } else {
      // K fragments by ldmatrix.x4: lane l addresses key nt * 8 + l % 8,
      // dims 8 * (l / 8) on from the k-step pair's first.
      const T* klane = Ks + (lane & 7) * STR + (lane >> 3) * 8;
#pragma unroll
      for (int ks = 0; ks + 1 < KSTEPS; ks += 2) {
        uint32_t qa[MT][2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4(qa[i][0], qlane + i * 16 * STR + ks * 16);
          ldsm_x4(qa[i][1], qlane + i * 16 * STR + ks * 16 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bb[4];
          ldsm_x4(bb, klane + nt * 8 * STR + ks * 16);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(s[i][nt], qa[i][0], bb[0], bb[1]);
            mma_bf16(s[i][nt], qa[i][1], bb[2], bb[3]);
          }
        }
      }
      if constexpr (KSTEPS % 2) {
        constexpr int ks = KSTEPS - 1;
        uint32_t qa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(qa[i], qlane + i * 16 * STR + ks * 16);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0, b1;
          ldsm_x2(b0, b1, Ks + (nt * 8 + (lane & 7)) * STR + ks * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16(s[i][nt], qa[i], b0, b1);
        }
      }
    }

    // Mask only tiles that cross the sequence end or this warp's diagonal
    // (rows pos0 + g: e = 0,1; pos0 + g + 8: e = 2,3).
    if (kv0 + BKV > S || (causal && kv0 + BKV - 1 > warp_first)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + nt * 8 + 2 * t + (e & 1);
            const int row = pos0[i] + g + (e < 2 ? 0 : 8);
            if (key >= S || (causal && key > row)) s[i][nt][e] = NEG_INF;
          }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[i][nt][0], s[i][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][nt][2], s[i][nt][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
      const float al0 = exp2f((m[i][0] - mn0) * sl2);
      const float al1 = exp2f((m[i][1] - mn1) * sl2);
      m[i][0] = mn0;
      m[i][1] = mn1;
      const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[i][nt][0] = exp2f(fmaf(s[i][nt][0], sl2, -ms0));
        s[i][nt][1] = exp2f(fmaf(s[i][nt][1], sl2, -ms0));
        s[i][nt][2] = exp2f(fmaf(s[i][nt][2], sl2, -ms1));
        s[i][nt][3] = exp2f(fmaf(s[i][nt][3], sl2, -ms1));
        ps0 += s[i][nt][0] + s[i][nt][1];
        ps1 += s[i][nt][2] + s[i][nt][3];
      }
      l[i][0] = l[i][0] * al0 + ps0;  // per-thread partial; the quad sums at the end
      l[i][1] = l[i][1] * al1 + ps1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[i][d][0] *= al0;
        acc[i][d][1] *= al0;
        acc[i][d][2] *= al1;
        acc[i][d][3] *= al1;
      }
    }

    // acc += P . V: the score tiles 2kk, 2kk+1 are P's k-step kk A fragment.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[MT][4], pl[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (E::kSplit) {
          split2(s[i][2 * kk][0], s[i][2 * kk][1], pa[i][0], pl[i][0]);
          split2(s[i][2 * kk][2], s[i][2 * kk][3], pa[i][1], pl[i][1]);
          split2(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1], pa[i][2], pl[i][2]);
          split2(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3], pa[i][3], pl[i][3]);
        } else {
          pa[i][0] = pack(s[i][2 * kk][0], s[i][2 * kk][1]);
          pa[i][1] = pack(s[i][2 * kk][2], s[i][2 * kk][3]);
          pa[i][2] = pack(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
          pa[i][3] = pack(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
        }
      }
      if constexpr (E::kSplit) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          // B fragment: V[2t, 2t+1 (+8)][dt * 8 + g], two rows apart.
          const T* vr = Vs + (kk * 16 + 2 * t) * STR + dt * 8 + g;
          uint32_t b0, b1, b0l, b1l;
          split2(vr[0], vr[STR], b0, b0l);
          split2(vr[8 * STR], vr[9 * STR], b1, b1l);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][dt], pa[i], b0, b1);
            mma_bf16(acc[i][dt], pa[i], b0l, b1l);
            mma_bf16(acc[i][dt], pl[i], b0, b1);
          }
        }
      } else {
        // Lane l addresses row l % 8 of matrix l / 8: keys kk * 16 + l % 8
        // (+8 for matrices 1 and 3), dims dt * 8 (+8 for matrices 2, 3);
        // transposed, they are the B fragments of n-tiles dt and dt + 1.
        const T* vr = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                      (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, vr + dt * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][dt], pa[i], bb[0], bb[1]);
            mma_bf16(acc[i][dt + 1], pa[i], bb[2], bb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float l0 = l[i][0], l1 = l[i][1];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    const int r0 = pos0[i] + g, r1 = r0 + 8;
    T* o0 = O + ((static_cast<size_t>(b) * S + r0) * H + head[i]) * HD;
    T* o1 = O + ((static_cast<size_t>(b) * S + r1) * H + head[i]) * HD;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (lives[i] && r0 < S) E::store2(o0 + c, acc[i][dt][0] * inv0, acc[i][dt][1] * inv0);
      if (lives[i] && r1 < S) E::store2(o1 + c, acc[i][dt][2] * inv1, acc[i][dt][3] * inv1);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const bool dead = (ROWS / 16) % G != 0;   // G = 3, 5, 6, 7
  const int bq = 16 * (ROWS / 16 / G);
  const int nq = (S + bq - 1) / bq;
  auto kernel = dead ? flash_kernel<T, HD, true> : flash_kernel<T, HD, false>;
  constexpr int smem = Smem<T, HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nq, B * KV), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, G, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int blocks_per_sm() {
  auto kernel = flash_kernel<T, HD, false>;
  constexpr int smem = Smem<T, HD>::BYTES;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int S, int H, int KV, int causal,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/out (B, S, H, hd), k/v (B, S, KV, hd), contiguous, bf16 (is_f32 = 0) or
// f32.  H / KV in 1..8; hd in {16, 32, 64, 128}; scale > 0.
// Launches on `stream` of `device`, does not synchronise, allocates
// nothing.  Returns the first CUDA error (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      float scale, int is_f32,
                                      void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (KV <= 0 || H % KV || H / KV < 1 || H / KV > ROWS / 16 ||
      S <= 0 || B * KV > 65535 ||
      !(scale > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f32)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, H, KV, causal, scale,
                              stream);
  return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KV, causal,
                                    scale, stream);
}

// Blocks of the kernel for head size hd (64 or 128) that one SM of `device`
// holds at once (its occupancy), or -1 on error.
extern "C" int flash_attention_blocks_per_sm(int hd, int is_f32, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (hd == 128) return is_f32 ? blocks_per_sm<float, 128>() : blocks_per_sm<__nv_bfloat16, 128>();
  if (hd == 64) return is_f32 ? blocks_per_sm<float, 64>() : blocks_per_sm<__nv_bfloat16, 64>();
  return -1;
}
