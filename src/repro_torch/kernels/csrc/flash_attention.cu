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
//    its group, so each K/V tile is read from device memory once for the G
//    heads; the (S, S) score matrix never exists;
//  * the kv loop runs inside the block, only up to the causal diagonal:
//    blocks above it issue no loads and no MMA (the TPU kernel's skipped
//    grid steps); q blocks are issued heaviest first;
//  * q, k, v are read in their native (B, S, heads, hd) layout by strides,
//    with no transposing copy; V is transposed on its way into shared memory
//    so that P.V's B fragments are 32-bit loads;
//  * Q.K^T and P.V run on mma.sync m16n8k16 with f32 accumulation; P stays
//    in registers between the two (the S accumulator fragment is P's A
//    fragment).  m, l and the output accumulator live in registers.
//  * bf16 inputs: Q.K^T is exact in f32 (bf16 x bf16 products); P is
//    rounded to bf16 for P.V.  f32 inputs: every operand is split into bf16
//    hi + lo (the paper's split) and each product is hi.hi + hi.lo + lo.hi,
//    which keeps the result within ~1e-5 of f32 attention.
// Simple first: one shared-memory stage, no cp.async/TMA, no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // query rows (all G heads) per block
constexpr int PAD = 8;            // elements; conflict-free fragment loads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  static constexpr int BKV = 64;  // keys per tile
  static constexpr int VEC = 8;   // elements per 16-byte vector
  static __device__ __forceinline__ void pair(const __nv_bfloat16* p,
                                              uint32_t& hi, uint32_t&) {
    hi = *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<uint32_t*>(p) = pack(x, y);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.0f);
  }
};

template <>
struct Elem<float> {
  static constexpr bool kSplit = true;
  static constexpr int BKV = 32;
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void pair(const float* p, uint32_t& hi,
                                              uint32_t& lo) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    split2(v.x, v.y, hi, lo);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, T* __restrict__ O, int S, int H,
                 int KV, int G, int causal, float scale) {
  using E = Elem<T>;
  constexpr int BKV = E::BKV;
  constexpr int KSTR = HD + PAD;   // Ks row stride (elements)
  constexpr int VSTR = BKV + PAD;  // Vt row stride (elements)
  constexpr int NT = BKV / 8;      // score n-tiles per kv tile
  constexpr int KSTEPS = HD / 16;  // k-steps of Q.K^T
  constexpr int DT = HD / 8;       // output n-tiles
  __shared__ __align__(16) T Ks[BKV * KSTR];
  __shared__ __align__(16) T Vt[HD * VSTR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bq = ROWS / G;                          // query rows per head
  const int nq = (S + bq - 1) / bq;
  const int iq = causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const int wph = WARPS / G;                        // warps per head
  const int head = kvh * G + warp / wph;
  const int q0 = iq * bq + (warp % wph) * 16;       // this warp's first row
  const int r0 = q0 + g, r1 = q0 + g + 8;

  // Q fragments (A operand), hi and (f32 path) lo.
  uint32_t qa[KSTEPS][4], ql[E::kSplit ? KSTEPS : 1][4];
  {
    const T* p0 = Q + ((static_cast<size_t>(b) * S + r0) * H + head) * HD;
    const T* p1 = Q + ((static_cast<size_t>(b) * S + r1) * H + head) * HD;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t lo[4] = {0u, 0u, 0u, 0u};
      const int c = ks * 16 + 2 * t;
      qa[ks][0] = qa[ks][1] = qa[ks][2] = qa[ks][3] = 0u;
      if (r0 < S) {
        E::pair(p0 + c, qa[ks][0], lo[0]);
        E::pair(p0 + c + 8, qa[ks][2], lo[2]);
      }
      if (r1 < S) {
        E::pair(p1 + c, qa[ks][1], lo[1]);
        E::pair(p1 + c + 8, qa[ks][3], lo[3]);
      }
      if constexpr (E::kSplit) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ql[ks][e] = lo[e];
      }
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  const int q_last = min(iq * bq + bq - 1, S - 1);  // block's last position
  const int kv_end = causal ? q_last + 1 : S;
  const int warp_last = q0 + 15;
  const size_t kv_row = static_cast<size_t>(KV) * HD;  // stride of one s
  const T* kbase = K + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const T* vbase = V + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // previous tile fully consumed
    constexpr int VPR = HD / E::VEC;  // vectors per row
    for (int idx = tid; idx < BKV * VPR; idx += THREADS) {
      const int key = idx / VPR, c = (idx % VPR) * E::VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kv0 + key < S) {
        kv = *reinterpret_cast<const uint4*>(kbase + (kv0 + key) * kv_row + c);
        vv = *reinterpret_cast<const uint4*>(vbase + (kv0 + key) * kv_row + c);
      }
      *reinterpret_cast<uint4*>(&Ks[key * KSTR + c]) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) Vt[(c + e) * VSTR + key] = ve[e];
    }
    __syncthreads();
    // A warp whose rows all sit above this tile (causal) has nothing to add.
    if (causal && kv0 > warp_last) continue;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const T* kr = &Ks[(nt * 8 + g) * KSTR + 2 * t];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b0, b1, b0l = 0u, b1l = 0u;
        E::pair(kr + ks * 16, b0, b0l);
        E::pair(kr + ks * 16 + 8, b1, b1l);
        mma_bf16(s[nt], qa[ks], b0, b1);
        if constexpr (E::kSplit) {
          mma_bf16(s[nt], qa[ks], b0l, b1l);
          mma_bf16(s[nt], ql[ks], b0, b1);
        }
      }
    }

    // Scale, mask, online softmax (rows r0: e = 0,1; r1: e = 2,3).
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = s[nt][e] * scale;
        if (key >= S || (causal && key > row)) x = NEG_INF;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;  // per-thread partial; the quad sums at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

    // acc += P . V: the score tiles 2j, 2j+1 are P's k-step j A fragment.
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t pa[4], pl[4] = {0u, 0u, 0u, 0u};
      if constexpr (E::kSplit) {
        split2(s[2 * j][0], s[2 * j][1], pa[0], pl[0]);
        split2(s[2 * j][2], s[2 * j][3], pa[1], pl[1]);
        split2(s[2 * j + 1][0], s[2 * j + 1][1], pa[2], pl[2]);
        split2(s[2 * j + 1][2], s[2 * j + 1][3], pa[3], pl[3]);
      } else {
        pa[0] = pack(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const T* vr = &Vt[(dt * 8 + g) * VSTR + j * 16 + 2 * t];
        uint32_t b0, b1, b0l = 0u, b1l = 0u;
        E::pair(vr, b0, b0l);
        E::pair(vr + 8, b1, b1l);
        mma_bf16(acc[dt], pa, b0, b1);
        if constexpr (E::kSplit) {
          mma_bf16(acc[dt], pa, b0l, b1l);
          mma_bf16(acc[dt], pl, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  T* o0 = O + ((static_cast<size_t>(b) * S + r0) * H + head) * HD;
  T* o1 = O + ((static_cast<size_t>(b) * S + r1) * H + head) * HD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < S) E::store2(o0 + c, acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < S) E::store2(o1 + c, acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const int nq = (S + ROWS / G - 1) / (ROWS / G);
  flash_kernel<T, HD><<<dim3(nq, B * KV), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, G, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
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
// f32.  H / KV in {1, 2, 4, 8}; hd in {16, 32, 64, 128}.  Launches on
// `stream` of `device`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      float scale, int is_f32,
                                      void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (KV <= 0 || H % KV || WARPS % (H / KV) || S <= 0 || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f32)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, H, KV, causal, scale,
                              stream);
  return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KV, causal,
                                    scale, stream);
}
