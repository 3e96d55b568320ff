// Kernel 4: single-token decode attention over a factored prefix + dense
// tail.  Slot b's rows [0, comp_len[b]) exist only as rank-r factors
// K ~ us_k.vt_k, V ~ us_v.vt_v; rows comp_len[b] <= i <= write_pos come from
// the dense cache; one softmax (optional tanh softcap) spans both.
//
// Replaces the Pallas TPU kernel `_fdec_kernel`
// (repro/kernels/factored_decode.py, entry `factored_decode_attention`).
//
// What bounds it on an H100: bytes.  Each live dense row costs 2 x hd cache
// values and 2 x 2 x G x hd operations; each factored row 2 x r f32 factor
// values and 2 x 2 x G x r operations -- far below the card's 295
// operations per byte.  The design:
//  * split-KV (flash-decoding): one block per (kv block, slot x kv head),
//    and only the kv blocks at or before write_pos are launched, so rows past
//    the clock are never read; a second small kernel merges the blocks'
//    (m, l, acc) partials.  At 8 slots x 8 kv heads this spreads the work
//    over more SMs than the 64 (slot, head) rows alone;
//  * the cache (B, S, KV, hd) and the factors (B, KV, S, r) are read in
//    place by strides -- no padded, transposed copy of the cache per step;
//  * skip rules per block and slot: a block with no row below comp_len
//    reads no factor operand, rows below comp_len read no dense cache row,
//    and a slot with comp_len == 0 never touches us/vt at all (the merge
//    kernel applies vt_v only where comp_len > 0);
//  * prefix scores are (q.vt_k^T).us_k^T and the prefix value sum stays
//    rank-r (acc_f = sum p.us_v) until the merge's acc_f.vt_v epilogue.
// All arithmetic is f32 FMA (no tensor cores): the work is a few MFLOP and
// the reference contract is <= 1e-5 on f32 inputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float& y, float x) { y = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& y, float x) {
  y = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  int S, H, KV, G, hd, r, wp, bkv, nblk;
  float scale, cap;
};

// Partial softmax of one kv block for the G heads of one (slot, kv head).
// Workspace per (row, block, head): m, l, acc_d[hd], acc_f[r].
template <typename TQ, typename T>
__global__ void __launch_bounds__(THREADS)
    fdec_partial(const TQ* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, const float* __restrict__ KUS,
                 const float* __restrict__ KVT, const float* __restrict__ VUS,
                 const int* __restrict__ comp_len, float* __restrict__ ws,
                 Args a) {
  extern __shared__ float sm[];
  const int G = a.G, hd = a.hd, r = a.r;
  float* qs = sm;              // (G, hd) query, f32
  float* qv = qs + G * hd;     // (G, r)  q . vt_k^T
  float* sc = qv + G * r;      // (G, bkv) scores, then probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, row = blockIdx.y;
  const int b = row / a.KV, kvh = row % a.KV;
  const int comp = comp_len[b];
  const int start = blk * a.bkv;
  const int end = min(min(start + a.bkv, a.S), a.wp + 1);
  const int n = end - start;                 // >= 1: only live blocks launch
  const int n_fact = max(0, min(comp, end) - start);  // rows [0, n_fact)
  const size_t kv_row = static_cast<size_t>(a.KV) * hd;
  const T* kb = K + (static_cast<size_t>(b) * a.S * a.KV + kvh) * hd;
  const T* vb = V + (static_cast<size_t>(b) * a.S * a.KV + kvh) * hd;
  const size_t frow = static_cast<size_t>(row) * a.S * r;  // us of this row

  for (int i = tid; i < G * hd; i += THREADS)
    qs[i] = to_f32(Q[(static_cast<size_t>(b) * a.H + kvh * G) * hd + i]);
  __syncthreads();
  if (n_fact > 0) {
    const float* vt = KVT + static_cast<size_t>(row) * r * hd;
    for (int i = tid; i < G * r; i += THREADS) {
      const int gh = i / r, j = i % r;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc += qs[gh * hd + d] * vt[j * hd + d];
      qv[i] = acc;
    }
    __syncthreads();
  }

  // Scores: one warp per position, lanes split the contraction.
  for (int p = warp; p < n; p += WARPS) {
    const int pos = start + p;
    for (int gh = 0; gh < G; ++gh) {
      float acc = 0.0f;
      if (p < n_fact) {
        const float* us = KUS + frow + static_cast<size_t>(pos) * r;
        for (int j = lane; j < r; j += 32) acc += qv[gh * r + j] * us[j];
      } else {
        const T* kr = kb + pos * kv_row;
        for (int d = lane; d < hd; d += 32) acc += qs[gh * hd + d] * to_f32(kr[d]);
      }
      acc = warp_sum(acc) * a.scale;
      if (a.cap > 0.0f) acc = tanhf(acc / a.cap) * a.cap;
      if (lane == 0) sc[gh * a.bkv + p] = acc;
    }
  }
  __syncthreads();

  float* wrow = ws + (static_cast<size_t>(row) * a.nblk + blk) * G * (2 + hd + r);
  for (int gh = warp; gh < G; gh += WARPS) {
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, sc[gh * a.bkv + p]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(sc[gh * a.bkv + p] - mx);
      sc[gh * a.bkv + p] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      wrow[gh * (2 + hd + r)] = mx;
      wrow[gh * (2 + hd + r) + 1] = l;
    }
  }
  __syncthreads();

  // Dense tail rows [n_fact, n) into acc_d; prefix rows into rank-r acc_f.
  for (int i = tid; i < G * hd; i += THREADS) {
    const int gh = i / hd, d = i % hd;
    float acc = 0.0f;
    for (int p = n_fact; p < n; ++p)
      acc += sc[gh * a.bkv + p] * to_f32(vb[(start + p) * kv_row + d]);
    wrow[gh * (2 + hd + r) + 2 + d] = acc;
  }
  for (int i = tid; i < G * r; i += THREADS) {
    const int gh = i / r, j = i % r;
    float acc = 0.0f;
    for (int p = 0; p < n_fact; ++p)
      acc += sc[gh * a.bkv + p] * VUS[frow + static_cast<size_t>(start + p) * r + j];
    wrow[gh * (2 + hd + r) + 2 + hd + j] = acc;
  }
}

// Merge the blocks' partials; epilogue (acc_f . vt_v + acc_d) / l.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
    fdec_merge(const float* __restrict__ ws, const float* __restrict__ VVT,
               const int* __restrict__ comp_len, TQ* __restrict__ O, Args a) {
  const int row = blockIdx.x;
  const int b = row / a.KV, kvh = row % a.KV;
  const int G = a.G, hd = a.hd, r = a.r, w = 2 + hd + r;
  const bool fact = comp_len[b] > 0;
  const float* wr = ws + static_cast<size_t>(row) * a.nblk * G * w;
  const float* vt = VVT + static_cast<size_t>(row) * r * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int gh = i / hd, d = i % hd;
    float m = -INFINITY;
    for (int k = 0; k < a.nblk; ++k) m = fmaxf(m, wr[(k * G + gh) * w]);
    float l = 0.0f, acc_d = 0.0f, out_f = 0.0f;
    for (int k = 0; k < a.nblk; ++k) {
      const float* p = wr + (k * G + gh) * w;
      const float c = expf(p[0] - m);
      l += p[1] * c;
      acc_d += p[2 + d] * c;
    }
    if (fact) {
      for (int j = 0; j < r; ++j) {
        float acc_f = 0.0f;
        for (int k = 0; k < a.nblk; ++k) {
          const float* p = wr + (k * G + gh) * w;
          acc_f += p[2 + hd + j] * expf(p[0] - m);
        }
        out_f += acc_f * vt[j * hd + d];
      }
    }
    from_f32(O[(static_cast<size_t>(b) * a.H + kvh * G + gh) * hd + d],
             (out_f + acc_d) / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* kus,
           const void* kvt, const void* vus, const void* vvt,
           const void* comp, void* out, void* ws, int B, const Args& a,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * a.G * (a.hd + a.r + a.bkv);
  fdec_partial<TQ, T><<<dim3(a.nblk, B * a.KV), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kus),
      static_cast<const float*>(kvt), static_cast<const float*>(vus),
      static_cast<const int*>(comp), static_cast<float*>(ws), a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fdec_merge<TQ><<<B * a.KV, THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(vvt),
      static_cast<const int*>(comp), static_cast<TQ*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (B, 1, H, hd) in bf16 or f32 (q_f32) and k/v (B, S, KV, hd) in bf16
// or f32 (kv_f32);
// k_us/v_us (B, KV, S, r), k_vt/v_vt (B, KV, r, hd) f32; comp_len (B,)
// int32; all contiguous.  ws holds B*KV*nblk*G*(2+hd+r) floats with
// nblk = ceil((write_pos+1)/block_kv).  Launches on `stream` of `device`,
// does not synchronise, allocates nothing.  Returns cudaGetLastError().
extern "C" int factored_decode_launch(
    const void* q, const void* k, const void* v, const void* kus,
    const void* kvt, const void* vus, const void* vvt, const void* comp,
    void* out, void* ws, int B, int S, int H, int KV, int hd, int r,
    int write_pos, int block_kv, float scale, float cap, int q_f32,
    int kv_f32, void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (KV <= 0 || H % KV || write_pos < 0 || write_pos >= S || block_kv <= 0 ||
      B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{S, H, KV, H / KV, hd, r, write_pos, block_kv,
         (write_pos + block_kv) / block_kv, scale, cap};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  if (q_f32 && kv_f32)
    return launch<float, float>(q, k, v, kus, kvt, vus, vvt, comp, out, ws, B,
                                a, stream);
  if (q_f32)
    return launch<float, bf16>(q, k, v, kus, kvt, vus, vvt, comp, out, ws, B,
                               a, stream);
  if (kv_f32)
    return launch<bf16, float>(q, k, v, kus, kvt, vus, vvt, comp, out, ws, B,
                               a, stream);
  return launch<bf16, bf16>(q, k, v, kus, kvt, vus, vvt, comp, out, ws, B, a,
                            stream);
}
