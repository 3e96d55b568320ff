// Kernel 4: single-token decode attention over a factored prefix + dense
// tail.  Slot b's rows [0, comp_len[b]) exist only as rank-r factors
// K ~ us_k.vt_k, V ~ us_v.vt_v; rows comp_len[b] <= i <= write_pos come from
// the dense cache; one softmax (optional tanh softcap) spans both.
//
// Replaces the Pallas TPU kernel `_fdec_kernel`
// (repro/kernels/factored_decode.py, entry `factored_decode_attention`).
//
// What bounds it on an H100: bytes and latency.  Each live dense row costs
// 2 x hd cache values and 2 x 2 x G x hd operations; each factored row 2 x r
// f32 factor values and 2 x 2 x G x r operations -- far below the card's 295
// operations per byte.  At the engine's clock (a few hundred live rows a
// slot) the call moves ~6 MB, so the chain of dependent memory trips inside
// a block sets its time; at a full slot (~37 MB) the rate at which blocks
// keep copies in flight does.  The design:
//  * a grid fixed by shapes alone: (P, B x KV) blocks, P from the host's
//    planner (`factored_decode.decode_plan`).  Each block reads write_pos
//    (a kernel argument, or one int32 on the device) and comp_len[b] itself
//    and takes an equal share of the live rows [0, write_pos], split on a
//    `grain`-row boundary; a block whose share is empty writes an empty
//    partial (m = -inf, l = 0).  So the launch does not change with the
//    decode clock, and rows past it are never read;
//  * one pass over the share in chunks of `ch` rows (prefix chunks first,
//    then tail chunks), each chunk's K and V rows (us_k and us_v rows in
//    the prefix) copied to shared memory by 16-byte cp.async through a
//    NSTAGE-deep ring, so chunks c + 1 and c + 2 load while chunk c is
//    scored; an online softmax (m, l, and the accumulators rescaled a
//    chunk) spans the chunks.  A row is scored by a lane group (hd / 8
//    lanes a bf16 row, r / 4 a factored row), ending in a shuffle tree;
//    the value sum gives each thread one 16-byte slice of a row for one
//    head over an interleaved subset of the chunk's rows, its accumulator
//    in shared memory, and the subsets are summed in a fixed order at the
//    end.  q . vt_k^T is computed by each block with prefix rows (vt_k is
//    16 KB, read from L2), its loads issued beside the first chunks';
//  * the skip rules of the TPU kernel: prefix rows read no dense row, tail
//    rows read no factor, a block with no prefix row reads no factor, and a
//    slot with comp_len == 0 never touches us/vt;
//  * a deterministic merge in the same launch: the last block of a (slot,
//    kv head) row to finish -- an atomic ticket it resets to 0 -- combines
//    the P partials (m, l, acc_d, acc_f) in split order 0..P-1, so the bits
//    do not depend on which block finished first, and then applies
//    acc_f . vt_v once: the prefix value sum stays rank-r until there.  Its
//    loads go out in batches, and every block of the row has fetched a
//    share of vt_v into L2 beforehand.  One launch instead of a partial and
//    a merge kernel saves a launch's latency and the merge kernel's tail.
// Shapes where a 16-byte copy does not fit (hd or r not a multiple of the
// vector) take the scalar instances and 4-byte copies.  All arithmetic is
// f32 FMA on the CUDA cores (no tensor cores: the work is a few MFLOP, G = 2
// query rows a block).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 3;           // chunks in the cp.async ring
constexpr int STAGE_BYTES = 16384;  // a chunk's K + V rows, at most
constexpr int EB = 4;               // merge: elements a thread sums at once
constexpr int KB = 8;               // ... over KB splits' loads at once
constexpr int QCOLS = 32;           // columns of vt_k a thread reads for q . vt_k^T
constexpr int MAX_DEVICES = 64;

// Rows a lane group (scores) or a thread (values) handles at once: their
// loads and shuffle trees are independent, so they overlap.
template <int V>
__host__ __device__ constexpr int rows_at_once() { return V == 1 ? 8 : 4; }

struct Args {
  int S, H, KV, G, hd, r, grain, splits;
  int wp;                      // write_pos, where it is not on the device
  float scale, cap;
  int ch, rs, chf, rsf;        // rows a chunk, bytes between staged rows:
                               // tail (cache) rows, then prefix (us) rows
  int sch;                     // score slots a head: max(ch, chf)
  int ld, lf, lq;              // lanes per dense row, factored row, vt_k row
  int q_f32;                   // q / out in f32 (else bf16)
  // shared memory, in f32 words from its start
  int o_qv, o_sc, o_ml, o_accd, o_accf, o_stage, o_cw, o_af;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_bits(uint32_t lo16) {
  return __uint_as_float(lo16 << 16);
}

// V consecutive elements at p (shared memory) as f32; p is 16-byte aligned
// when V > 1.
template <int V, typename T>
__device__ __forceinline__ void lds_vec(const T* p, float (&x)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4)
      x[0] = *reinterpret_cast<const float*>(p);
    else
      x[0] = bf16_bits(*reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = u.x; x[4 * i + 1] = u.y; x[4 * i + 2] = u.z; x[4 * i + 3] = u.w;
    }
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_bits(w[i] & 0xffffu);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Sum over aligned groups of `lanes` lanes (a power of two); every lane of
// the warp takes part.
__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy nrows global rows, `bytes` long and `gstride` bytes apart, to dst,
// rs bytes apart: 16-byte cp.async where the rows allow it, else 4-byte,
// else (odd bf16 rows) plain loads and stores.  A thread's (row, offset)
// advances by THREADS units a step without a division.
__device__ void stage_rows(char* dst, const char* src, size_t gstride,
                           int nrows, int bytes, int rs) {
  const int gran = bytes % 16 == 0 ? 16 : bytes % 4 == 0 ? 4 : 2;
  const int per = bytes / gran, di = THREADS / per, dof = THREADS % per;
  int i = threadIdx.x / per, o = threadIdx.x % per;
  while (i < nrows) {
    char* d = dst + i * rs + o * gran;
    const char* s = src + i * gstride + o * gran;
    if (gran == 16)
      cp_async16(d, s);
    else if (gran == 4)
      cp_async4(d, s);
    else
      *reinterpret_cast<unsigned short*>(d) = __ldg(reinterpret_cast<const unsigned short*>(s));
    o += dof;
    i += di;
    if (o >= per) {
      o -= per;
      ++i;
    }
  }
}

// Scores of a chunk's nr staged rows (of `cap`; `len` elements in vectors of
// V, rs bytes apart) against src[g * len ...] (f32, shared) for each head g, into
// sc[g * sch + i].  A warp's lanes form groups of `lanes` (a power of two),
// one row a group; a group takes rows_at_once rows together.
template <int V, typename T>
__device__ void score_chunk(const char* rows, int rs, int cap, int nr, int len,
                            int lanes, const float* src, float* sc, const Args& a) {
  constexpr int R = rows_at_once<V>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = __ffs(lanes) - 1;
  const int grp = lane >> lg, li = lane & (lanes - 1);
  const int per_warp = 32 >> lg, stride = WARPS * per_warp, nvec = len / V;
  const int first = warp * per_warp + grp;     // the group's rows: first + k * stride
  const int last = cap - 1;                    // a row past nr reads a stale one
  // one vector of a row a lane (the usual case): the rows are read once for
  // every head
  const bool one = nvec <= lanes;
  // the bound is the same for every lane of the warp: the shuffles see all 32
  for (int k0 = 0; warp * per_warp + k0 * stride < nr; k0 += R) {
    float x[R][V];
    auto load_rows = [&](int c) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = min(first + (k0 + u) * stride, last);
        lds_vec<V>(reinterpret_cast<const T*>(rows + i * rs) + min(c, nvec - 1) * V, x[u]);
      }
    };
    if (one) load_rows(li);
    for (int g = 0; g < a.G; ++g) {
      float part[R];
#pragma unroll
      for (int u = 0; u < R; ++u) part[u] = 0.0f;
      for (int c = li; c < nvec; c += lanes) {
        float q[V];
        lds_vec<V>(src + g * len + c * V, q);
        if (!one) load_rows(c);
#pragma unroll
        for (int u = 0; u < R; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) part[u] = fmaf(q[e], x[u][e], part[u]);
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < R; ++u) part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = first + (k0 + u) * stride;
        float s = part[u] * a.scale;
        if (a.cap > 0.0f) s = tanhf(s / a.cap) * a.cap;
        if (li == 0 && i < nr) sc[g * a.sch + i] = s;
      }
    }
  }
}

// A `len`-wide accumulator is split into (head, vector) pairs, and each
// pair's sum over rows into `subsets(pairs)` row subsets while pairs are
// fewer than the threads; the accumulator of (pair, subset) is acc[(subset
// * pairs + pair) * V ...] in shared memory, neighbouring pairs on
// neighbouring words.
__host__ __device__ __forceinline__ int subsets(int pairs) {
  return pairs >= THREADS ? 1 : THREADS / pairs;
}

// A thread's (pair, subset) of a `len`-wide accumulator, worked out once:
// pair = round * slots + lp for the rounds while pairs outnumber slots.
struct ValMap {
  int nvec, pairs, groups, slots, sub, lp;
};

__device__ __forceinline__ ValMap value_map(int len, int V, int G) {
  ValMap m;
  m.nvec = len / V;
  m.pairs = G * m.nvec;
  m.groups = subsets(m.pairs);
  m.slots = THREADS / m.groups;
  m.sub = threadIdx.x / m.slots;
  m.lp = threadIdx.x % m.slots;
  return m;
}

// acc = acc * alpha[g] + sum over the chunk's rows i of p[g][i] * row_i
// (of `cap` staged rows, rs bytes apart), for each head g: a thread a (pair, subset), its
// rows i = subset + k * groups, rows_at_once of them together.
template <int V, typename T>
__device__ void value_chunk(const char* rows, int rs, int cap, int nr,
                            const ValMap& m, const float* p, const float* alpha,
                            float* acc, const Args& a) {
  constexpr int R = rows_at_once<V>();
  if (m.sub >= m.groups) return;
  for (int pb = 0; pb < m.pairs; pb += m.slots) {
    const int pair = pb + m.lp;
    if (pair >= m.pairs) break;
    const int g = pair / m.nvec, c = pair - g * m.nvec;
    float* slot = acc + (m.sub * m.pairs + pair) * V;
    const float al = alpha[g];
    float y[V];
#pragma unroll
    for (int e = 0; e < V; ++e) y[e] = slot[e] * al;
    for (int i0 = m.sub; i0 < nr; i0 += R * m.groups) {
      float w[R], x[R][V];
#pragma unroll
      for (int u = 0; u < R; ++u) {   // a row past nr reads a stale one
        const int i = min(i0 + u * m.groups, cap - 1);
        w[u] = p[g * a.sch + i];
        lds_vec<V>(reinterpret_cast<const T*>(rows + i * rs) + c * V, x[u]);
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (i0 + u * m.groups < nr)
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = fmaf(w[u], x[u][e], y[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) slot[e] = y[e];
  }
}

// out[g * W + j] = scale[g] * (sum over subsets of the accumulator, in
// subset order) for every head g and column j < len; no scale if null.
template <int V>
__device__ void reduce_subsets(const float* acc, int len, const float* scale,
                               float* out, int W, const Args& a) {
  const int nvec = len / V, pairs = a.G * nvec, groups = subsets(pairs);
  for (int i = threadIdx.x; i < a.G * len; i += THREADS) {
    const int g = i / len, j = i % len;
    const float* s = acc + (g * nvec + j / V) * V + j % V;
    float t = 0.0f;
    for (int k = 0; k < groups; ++k) t += s[k * pairs * V];
    out[g * W + j] = scale ? t * scale[g] : t;
  }
}

// One block: split blockIdx.x of the live rows of (slot, kv head)
// blockIdx.y, for its G query heads; the last block of the row to finish
// merges the row's P partials and writes the output.
// Workspace per (row, split, head): m, l, acc_d[hd], acc_f[r].
template <typename T, int VD, int VF>
__global__ void __launch_bounds__(THREADS, 4)
    fdec_kernel(const void* __restrict__ Q, const T* __restrict__ K,
                const T* __restrict__ Vc, const float* __restrict__ KUS,
                const float* __restrict__ KVT, const float* __restrict__ VUS,
                const float* __restrict__ VVT, const int* __restrict__ comp_len,
                const int* __restrict__ wp_dev, void* __restrict__ O,
                float* __restrict__ ws, unsigned int* __restrict__ tickets,
                Args a) {
  extern __shared__ __align__(16) float sm[];
  const int G = a.G, hd = a.hd, r = a.r, P = a.splits, W = 2 + hd + r;
  float* qs = sm;                  // (G, hd) query, f32
  float* qv = sm + a.o_qv;         // (G, r) q . vt_k^T
  float* sc = sm + a.o_sc;         // (G, sch) a chunk's scores, then p
  float* ml = sm + a.o_ml;         // (4, G): m, l, alpha, m after the prefix
  float* accd = sm + a.o_accd;     // value sums of the tail, by (pair, subset)
  float* accf = sm + a.o_accf;     // ... and of the prefix (rank r)
  char* stage = reinterpret_cast<char*>(sm + a.o_stage);  // NSTAGE chunks
  float* cw = sm + a.o_cw;         // merge, over the ring: (2, G, P) m_k, then
  float* af = sm + a.o_af;         // weights, and l_k; (G, r) merged acc_f
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, row = blockIdx.y;
  const int b = row / a.KV, kvh = row % a.KV;

  // q's loads leave first: they need neither the clock nor comp_len
  constexpr int QPT = 8;
  const size_t q0 = (static_cast<size_t>(b) * a.H + kvh * G) * hd;
  float qr[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = min(tid + k * THREADS, G * hd - 1);   // clamped: no branch
    qr[k] = a.q_f32 ? __ldg(static_cast<const float*>(Q) + q0 + i)
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(Q)[q0 + i]);
  }
  const int wp = wp_dev ? __ldg(wp_dev) : a.wp;
  const bool ok = 0 <= wp && wp < a.S;   // else every share is empty: NaN out
  const int live = ok ? wp + 1 : 0;
  const int per = ((live + a.grain - 1) / a.grain + P - 1) / P * a.grain;
  const int start = min(split * per, live);
  const int n = min(start + per, live) - start;
  const int comp = max(0, min(__ldg(comp_len + b), live));
  const int n_fact = max(0, min(comp - start, n));       // rows [0, n_fact)
  const size_t kv_row = static_cast<size_t>(a.KV) * hd;
  float* wrow = ws + (static_cast<size_t>(row) * P + split) * G * W;
  const float* vtk = KVT + static_cast<size_t>(row) * r * hd;
  const float* vtv = VVT + static_cast<size_t>(row) * r * hd;
  if (comp > 0) {
    // vt_v waits in L2 for the merge: each block of the row fetches 1/P of
    // its 128-byte lines
    const int lines = (r * hd + 31) / 32;
    for (int i = split + P * tid; i < lines; i += P * THREADS)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(vtv + 32 * i));
  }

  if (n > 0) {
    const char* kf = reinterpret_cast<const char*>(
        KUS + (static_cast<size_t>(row) * a.S + start) * r);
    const char* vf = reinterpret_cast<const char*>(
        VUS + (static_cast<size_t>(row) * a.S + start) * r);
    const size_t cache0 = (static_cast<size_t>(b) * a.S + start) * kv_row + kvh * hd;
    const char* kd = reinterpret_cast<const char*>(K + cache0);
    const char* vd = reinterpret_cast<const char*>(Vc + cache0);
    const int nfc = (n_fact + a.chf - 1) / a.chf;             // prefix chunks
    const int nc = nfc + (n - n_fact + a.ch - 1) / a.ch;
    const int stage_bytes = 2 * max(a.ch * a.rs, a.chf * a.rsf);
    // chunk c into its stage, then one commit group whether or not c exists
    auto issue = [&](int c) {
      if (c < nc) {
        char* dst = stage + (c % NSTAGE) * stage_bytes;
        if (c < nfc) {
          const int i0 = c * a.chf, nr = min(a.chf, n_fact - i0);
          const size_t rb = static_cast<size_t>(r) * 4;
          stage_rows(dst, kf + i0 * rb, rb, nr, r * 4, a.rsf);
          stage_rows(dst + a.chf * a.rsf, vf + i0 * rb, rb, nr, r * 4, a.rsf);
        } else {
          const int i0 = n_fact + (c - nfc) * a.ch, nr = min(a.ch, n - i0);
          const size_t rb = kv_row * sizeof(T);
          const int bytes = hd * static_cast<int>(sizeof(T));
          stage_rows(dst, kd + i0 * rb, rb, nr, bytes, a.rs);
          stage_rows(dst + a.ch * a.rs, vd + i0 * rb, rb, nr, bytes, a.rs);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int c = 0; c < NSTAGE - 1; ++c) issue(c);

    // qv[g][j] = q[g] . vt_k[j]: a thread reads QCOLS columns of one row j
    // (a.lq threads a row, in one lane group); its first loads leave beside
    // the first chunks' copies and before q lands in shared memory.
    const int pairs = n_fact > 0 ? r * a.lq : 0;
    float x[QCOLS];
    // Loads from clamped addresses, unconditionally, so that they all leave
    // together; what lies outside the row is dropped after.
    auto load_vtk = [&](int pair) {
      const int j = min(pair / a.lq, r - 1), d0 = pair % a.lq * QCOLS;
      const float* src = vtk + static_cast<size_t>(j) * hd;
      if (hd % 4 == 0) {
#pragma unroll
        for (int i = 0; i < QCOLS / 4; ++i) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(src + min(d0 + 4 * i, hd - 4)));
          x[4 * i] = u.x; x[4 * i + 1] = u.y; x[4 * i + 2] = u.z; x[4 * i + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < QCOLS; ++e) x[e] = __ldg(src + min(d0 + e, hd - 1));
      }
    };
    if (pairs > 0) load_vtk(tid);
#pragma unroll
    for (int k = 0; k < QPT; ++k)
      if (tid + k * THREADS < G * hd) qs[tid + k * THREADS] = qr[k];
    for (int i = tid + QPT * THREADS; i < G * hd; i += THREADS)
      qs[i] = a.q_f32 ? static_cast<const float*>(Q)[q0 + i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(Q)[q0 + i]);
    const int nvd = hd / VD, nvf = r / VF;
    for (int i = tid; i < G * nvd * subsets(G * nvd) * VD; i += THREADS) accd[i] = 0.0f;
    for (int i = tid; i < G * nvf * subsets(G * nvf) * VF; i += THREADS) accf[i] = 0.0f;
    if (tid < G) {
      ml[tid] = -INFINITY;
      ml[G + tid] = 0.0f;
      ml[3 * G + tid] = -INFINITY;
    }
    __syncthreads();                    // q in shared memory
    for (int base = 0; base < pairs; base += THREADS) {   // block-uniform
      const int pair = base + tid, j = pair / a.lq, d0 = pair % a.lq * QCOLS;
      for (int g = 0; g < G; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < QCOLS; ++e)
          if (d0 + e < hd) part = fmaf(qs[g * hd + d0 + e], x[e], part);
        part = group_sum(part, a.lq);
        if (pair < pairs && d0 == 0) qv[g * r + j] = part;
      }
      if (base + THREADS < pairs) load_vtk(base + THREADS + tid);
    }

    const ValMap vmd = value_map(hd, VD, G), vmf = value_map(r, VF, G);
    for (int c = 0; c < nc; ++c) {
      // chunk c has landed (this thread's copies; the barrier makes every
      // thread's visible), every warp is done with chunk c - 1, whose stage
      // the next copy refills, and qv is complete
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      issue(c + NSTAGE - 1);
      const char* rows = stage + (c % NSTAGE) * stage_bytes;
      const bool fact = c < nfc;
      const int nr = fact ? min(a.chf, n_fact - c * a.chf)
                          : min(a.ch, n - n_fact - (c - nfc) * a.ch);
      if (fact)
        score_chunk<VF, float>(rows, a.rsf, a.chf, nr, r, a.lf, qv, sc, a);
      else
        score_chunk<VD, T>(rows, a.rs, a.ch, nr, hd, a.ld, qs, sc, a);
      __syncthreads();
      // online softmax over the chunk, a warp a head
      for (int g = warp; g < G; g += WARPS) {
        float* s = sc + g * a.sch;
        float mc = -INFINITY;
        for (int i = lane; i < nr; i += 32) mc = fmaxf(mc, s[i]);
        const float m_old = ml[g];
        const float m_new = fmaxf(m_old, warp_max(mc));
        float sum = 0.0f;
        for (int i = lane; i < nr; i += 32) {
          const float e = expf(s[i] - m_new);
          s[i] = e;
          sum += e;
        }
        sum = group_sum(sum, 32);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          ml[g] = m_new;
          ml[G + g] = ml[G + g] * alpha + sum;
          ml[2 * G + g] = alpha;
          if (fact) ml[3 * G + g] = m_new;
        }
      }
      __syncthreads();
      if (fact)
        value_chunk<VF, float>(rows + a.chf * a.rsf, a.rsf, a.chf, nr, vmf, sc,
                               ml + 2 * G, accf, a);
      else
        value_chunk<VD, T>(rows + a.ch * a.rs, a.rs, a.ch, nr, vmd, sc, ml + 2 * G,
                           accd, a);
    }
    __syncthreads();
    // acc_f was kept against m after the prefix: bring it to the final m
    if (tid < G) {
      ml[2 * G + tid] = expf(ml[3 * G + tid] - ml[tid]);
      wrow[tid * W] = ml[tid];
      wrow[tid * W + 1] = ml[G + tid];
    }
    __syncthreads();
    reduce_subsets<VD>(accd, hd, nullptr, wrow + 2, W, a);
    if (comp > 0)  // acc_f of every split of a compressed slot, zero or not
      reduce_subsets<VF>(accf, r, ml + 2 * G, wrow + 2 + hd, W, a);
  } else if (tid < G) {
    wrow[tid * W] = -INFINITY;       // an empty share: the merge skips it
    wrow[tid * W + 1] = 0.0f;
  }

  // Ticket: the block that takes P - 1 saw every other partial land.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + row, 1u) == static_cast<unsigned>(P - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Merge in split order 0..P-1; partials of other blocks are read from L2.
  // A thread's loads of the acc partials of its first EB elements x KB
  // splits leave first (from clamped addresses, so that no branch holds
  // them back), then those of m_k and l_k.
  const float* wr = ws + static_cast<size_t>(row) * P * G * W;
  const int cols = comp > 0 ? hd + r : hd, E = G * cols;
  float y[EB][KB];
  auto load_acc = [&](int e0, int k0) {
#pragma unroll
    for (int v = 0; v < EB; ++v) {
      const int e = min(e0 + v * THREADS + tid, E - 1), g = e / cols, col = e % cols;
#pragma unroll
      for (int u = 0; u < KB; ++u)
        y[v][u] = __ldcg(wr + (min(k0 + u, P - 1) * G + g) * W + 2 + col);
    }
  };
  float vcol[32];
  auto load_vtv = [&](int d, int j0) {
#pragma unroll
    for (int u = 0; u < 32; ++u)
      vcol[u] = __ldg(vtv + static_cast<size_t>(min(j0 + u, r - 1)) * hd + min(d, hd - 1));
  };
  load_acc(0, 0);
  // weights c_k = exp(m_k - m) a (head, split); an empty split weighs 0 and
  // its (unwritten) acc is dropped
  float* lk_s = cw + G * P;
  for (int g = warp; g < G; g += WARPS) {
    float mx = -INFINITY;
    for (int k = lane; k < P; k += 32) {
      const float lk = __ldcg(wr + (k * G + g) * W + 1);
      const float mk = __ldcg(wr + (k * G + g) * W);
      cw[g * P + k] = mk;
      lk_s[g * P + k] = lk;
      if (lk != 0.0f) mx = fmaxf(mx, mk);
    }
    mx = warp_max(mx);
    float l = 0.0f;
    for (int k = lane; k < P; k += 32) {
      const float lk = lk_s[g * P + k];
      float c = 0.0f;
      if (lk != 0.0f) {                // NaN (a NaN input) is kept
        c = expf(cw[g * P + k] - mx);
        l += lk * c;
      }
      cw[g * P + k] = c;
    }
    l = group_sum(l, 32);
    if (lane == 0) ml[G + g] = l;
  }
  __syncthreads();
  // acc_d (into qs) and acc_f (into af) = sum over splits of c_k * acc[k]
  float* ad = qs;
  for (int e0 = 0; e0 < E; e0 += EB * THREADS) {
    float acc[EB];
#pragma unroll
    for (int v = 0; v < EB; ++v) acc[v] = 0.0f;
    for (int k0 = 0; k0 < P; k0 += KB) {
      if (e0 + k0 > 0) load_acc(e0, k0);
#pragma unroll
      for (int v = 0; v < EB; ++v) {
        const int e = e0 + v * THREADS + tid, g = min(e / cols, G - 1);
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const float c = e < E && k0 + u < P ? cw[g * P + k0 + u] : 0.0f;
          if (c != 0.0f) acc[v] = fmaf(c, y[v][u], acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < EB; ++v) {
      const int e = e0 + v * THREADS + tid, g = e / cols, col = e % cols;
      if (e < E) {
        if (col < hd)
          ad[g * hd + col] = acc[v];
        else
          af[g * r + col - hd] = acc[v];
      }
    }
  }
  __syncthreads();
  // out = (acc_f . vt_v + acc_d) / l: a thread a column d of vt_v
  int held_d = -1, held_j = 0;         // the piece vcol holds
  for (int d = tid; d < hd; d += THREADS) {
    for (int g = 0; g < G; ++g) {
      float out_f = 0.0f;
      if (comp > 0) {
        for (int j0 = 0; j0 < r; j0 += 32) {
          if (held_d != d || held_j != j0) {   // heads after the first reuse it
            load_vtv(d, j0);
            held_d = d;
            held_j = j0;
          }
#pragma unroll
          for (int u = 0; u < 32; ++u)
            if (j0 + u < r) out_f = fmaf(af[g * r + j0 + u], vcol[u], out_f);
        }
      }
      const float o = ok ? (out_f + ad[g * hd + d]) / fmaxf(ml[G + g], 1e-30f) : NAN;
      if (a.q_f32)
        static_cast<float*>(O)[q0 + g * hd + d] = o;
      else
        static_cast<__nv_bfloat16*>(O)[q0 + g * hd + d] = __float2bfloat16_rn(o);
    }
  }
  if (tid == 0) tickets[row] = 0u;   // the next launch starts from 0
}

__global__ void fdec_empty() {}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

int pad4(int x) { return (x + 3) / 4 * 4; }

// Vector widths: 16 bytes where the rows allow it, else one element.
int dense_vec(int hd, int elem) { return hd % (16 / elem) == 0 ? 16 / elem : 1; }
int fact_vec(int r) { return r % 4 == 0 ? 4 : 1; }

// The shared-memory layout (f32 words); `factored_decode.smem_bytes` on the
// host repeats it.  Returns the bytes.
size_t layout(Args& a, int elem) {
  const int G = a.G, vd = dense_vec(a.hd, elem), vf = fact_vec(a.r);
  const int pd = G * (a.hd / vd), pf = G * (a.r / vf);
  a.rs = (a.hd * elem + 15) / 16 * 16;
  a.rsf = (a.r * 4 + 15) / 16 * 16;
  a.ch = std::min(64, std::max(8, STAGE_BYTES / (2 * a.rs) / 8 * 8));
  a.chf = std::min(64, std::max(8, STAGE_BYTES / (2 * a.rsf) / 8 * 8));
  a.sch = std::max(a.ch, a.chf);
  a.o_qv = pad4(G * a.hd);
  a.o_sc = a.o_qv + pad4(G * a.r);
  a.o_ml = a.o_sc + pad4(G * a.sch);
  a.o_accd = a.o_ml + pad4(4 * G);
  a.o_accf = a.o_accd + pad4(pd * subsets(pd) * vd);
  a.o_stage = a.o_accf + pad4(pf * subsets(pf) * vf);
  // the merge's scratch reuses the ring, idle by then
  a.o_cw = a.o_stage;
  a.o_af = a.o_cw + pad4(2 * G * a.splits);
  const int ring = NSTAGE * 2 * std::max(a.ch * a.rs, a.chf * a.rsf) / 4;
  return sizeof(float) *
         static_cast<size_t>(a.o_stage + std::max(ring, a.o_af - a.o_cw + G * a.r));
}

template <typename T, int VD, int VF>
int launch(const void* q, const void* k, const void* v, const void* kus,
           const void* kvt, const void* vus, const void* vvt, const void* comp,
           const void* wp_dev, void* out, void* ws, void* tickets, int B,
           Args a, size_t smem, cudaStream_t stream, int device) {
  a.ld = std::min(32, pow2_at_least(a.hd / VD));
  a.lf = std::min(32, pow2_at_least(a.r / VF));
  a.lq = pow2_at_least((a.hd + QCOLS - 1) / QCOLS);
  // this instance's shared-memory ceiling on each device, raised once
  static size_t opted[MAX_DEVICES] = {};
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fdec_kernel<T, VD, VF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[device] = smem;
  }
  fdec_kernel<T, VD, VF><<<dim3(a.splits, B * a.KV), THREADS, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kus), static_cast<const float*>(kvt),
      static_cast<const float*>(vus), static_cast<const float*>(vvt),
      static_cast<const int*>(comp), static_cast<const int*>(wp_dev), out,
      static_cast<float*>(ws), static_cast<unsigned int*>(tickets), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kus,
             const void* kvt, const void* vus, const void* vvt,
             const void* comp, const void* wp_dev, void* out, void* ws,
             void* tickets, int B, Args a, cudaStream_t stream, int device) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = layout(a, sizeof(T));
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vd = dense_vec(a.hd, sizeof(T)) == VEC, vf = fact_vec(a.r) == 4;
  if (vd && vf)
    return launch<T, VEC, 4>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev, out,
                             ws, tickets, B, a, smem, stream, device);
  if (vd)
    return launch<T, VEC, 1>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev, out,
                             ws, tickets, B, a, smem, stream, device);
  if (vf)
    return launch<T, 1, 4>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev, out,
                           ws, tickets, B, a, smem, stream, device);
  return launch<T, 1, 1>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev, out, ws,
                         tickets, B, a, smem, stream, device);
}

}  // namespace

// q/out (B, 1, H, hd) in bf16 or f32 (q_f32); k/v (B, S, KV, hd) in bf16 or
// f32 (kv_f32); k_us/v_us (B, KV, S, r), k_vt/v_vt (B, KV, r, hd) f32;
// comp_len (B,) int32; all contiguous and 16-byte aligned.  write_pos is
// *wp_dev (one int32 on the device) where wp_dev is not null, else the
// argument; out of [0, S) it gives NaN outputs.  ws holds
// B*KV*splits*G*(2+hd+r) floats; tickets B*KV zeros, left zero.  Launches
// on `stream` of `device`, does not synchronise, allocates nothing.
// Returns cudaGetLastError().
extern "C" int factored_decode_launch(
    const void* q, const void* k, const void* v, const void* kus,
    const void* kvt, const void* vus, const void* vvt, const void* comp,
    const void* wp_dev, void* out, void* ws, void* tickets, int B, int S,
    int H, int KV, int hd, int r, int write_pos, int grain, int splits,
    float scale, float cap, int q_f32, int kv_f32, void* stream_ptr,
    int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (device < 0 || device >= MAX_DEVICES || KV <= 0 || H % KV || hd <= 0 ||
      hd > 32 * QCOLS || r <= 0 || grain <= 0 || splits <= 0 || B * KV > 65535 ||
      (!wp_dev && (write_pos < 0 || write_pos >= S)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.S = S; a.H = H; a.KV = KV; a.G = H / KV; a.hd = hd; a.r = r;
  a.grain = grain; a.splits = splits; a.wp = write_pos;
  a.scale = scale; a.cap = cap; a.q_f32 = q_f32;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kv_f32)
    return dispatch<float>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev, out, ws,
                           tickets, B, a, stream, device);
  return dispatch<__nv_bfloat16>(q, k, v, kus, kvt, vus, vvt, comp, wp_dev,
                                 out, ws, tickets, B, a, stream, device);
}

// One launch of an empty kernel on `stream`: the latency floor of any
// launch, beside which kernel 4's time is read.
extern "C" int factored_decode_empty_launch(void* stream_ptr, int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  fdec_empty<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return static_cast<int>(cudaGetLastError());
}
