// GQA split-KV flash-decode, dense and paged, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/kernel.py:
// _decode_kernel (:27, launched by decode_attention_call, pallas_call at
// :194) and _paged_decode_kernel (:73, paged_decode_attention_call, :171).
// One query token a sequence attends over its KV cache, keys masked to
// pos - window < p <= pos[b], softmax in f32, output (B, Hq, hd) in the
// operands' type.
//
// What bounds it on an H100: KV bytes.  Each cached row is read once a
// layer and used for g = Hq / Hkv dot products: about 4 flop a byte at
// g = 4, far below even the CUDA cores' ridge (~20 flop a byte).  The
// levers are parallelism over the cache, bytes in flight, and few enough
// instructions a key that the arithmetic hides under the loads.
//
// What the design does about it:
//  * split-KV: one CTA per (sequence, kv head, split of kSplit = 128
//    keys), the splits at multiples of kSplit in absolute key position.
//    The grid is sized from n_keys alone (never from a host read of pos)
//    and a CTA whose split holds no visible key exits at once.  Each CTA
//    serves the whole GQA group, so each K/V row still leaves device
//    memory once.  A row's split boundaries depend only on its pos, the
//    window and kSplit, not on S, the batch or the layout, and the dense
//    and paged forms are one template that differs only in the address of
//    key row p: on the same logical contents they are bitwise equal;
//  * bytes in flight: each of the 4 warps owns one 32-key tile of the
//    split and moves its K and V rows to shared memory in the operands'
//    own type with 16-byte cp.async copies, K and V as two groups in
//    flight together (a two-stage pipeline: the scores run on K while V
//    lands).  A split's whole K/V is in flight at once and several CTAs
//    share an SM, so a deeper ring has nothing to add.  Rows outside the
//    visible range are zero-filled from a safe address, never through a
//    table entry.  A warp's stages are ordered by __syncwarp alone: no
//    block-wide barrier per tile;
//  * arithmetic: bf16 at hd 16, 32, 64 or 128 with g <= 16 (every model
//    path) runs on the tensor cores, as kernel 3 does: the group's query
//    heads are the m16 rows of mma.sync m16n8k16, q stays in registers as
//    A fragments, K comes in as B fragments through ldmatrix, P goes from
//    the score accumulators to A fragments without leaving registers
//    (rounded to bf16; the plain version keeps it f32) and V through
//    ldmatrix.trans.  f32 and the other bf16 shapes run on the CUDA cores:
//    one key a lane, q in shared memory as f32 (broadcast reads), the
//    softmax's max and sum by warp shuffles.  Both mask by select, never
//    by a multiply (0 * inf is NaN);
//  * combine: the warps' states merge in shared memory, in warp order,
//    into one f32 partial (m, l, acc) per query head and split, written to
//    a workspace the wrapper allocates; a second launch (programmatic
//    dependent launch: it is scheduled while the first drains) merges a
//    row's live splits in ascending order and divides by max(l,
//    kMinDenom).  No atomics and no host counter: two calls are bitwise
//    equal and a captured CUDA graph can replay the pair.  A row with no
//    visible key (pos < 0) has no live split and gets zeros.

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                // keys of a warp's tile
constexpr int kSplit = kWarps * kTile;   // keys of a split, both types
constexpr int kHeadGroup = 8;     // query heads whose scores a lane holds
constexpr int kAccVec = 4;        // consecutive output elements a lane owns
constexpr int kMaxGroupWidth = 1024;                      // g * hd
constexpr int kMaxAcc = kMaxGroupWidth / (32 * kAccVec);  // chunks a lane
constexpr int kMaxHd = 128;
constexpr int kTcMaxGroup = 16;   // query heads of the tensor-core form

// The visible keys of a row, [first, last]; empty when last < first.
__host__ __device__ inline void visible(int pos, int n_keys, int window,
                                        int* first, int* last) {
  *last = pos < n_keys - 1 ? pos : n_keys - 1;
  const int lo = *last - window + 1;
  *first = window > 0 && lo > 0 ? lo : 0;
}

__host__ __device__ inline int n_splits(int n_keys) {
  return (n_keys + kSplit - 1) / kSplit;
}

// The live splits of a row, [lo, hi]; hi < lo when it sees no key.
__host__ __device__ inline void live_splits(int pos, int n_keys, int window,
                                            int* lo, int* hi) {
  int first, last;
  visible(pos, n_keys, window, &first, &last);
  if (last < first) {
    *lo = 0;
    *hi = -1;
    return;
  }
  *lo = first / kSplit;
  *hi = last / kSplit;
}

struct DenseRows {
  int S;  // cache length
  __device__ __forceinline__ long long row(int b, int p, int Hkv, int u,
                                           int hd) const {
    return ((static_cast<long long>(b) * S + p) * Hkv + u) * hd;
  }
};

struct PagedRows {
  const int* tbl;  // (B, max_blocks) logical -> physical block
  int bs;
  int max_blocks;
  __device__ __forceinline__ long long row(int b, int p, int Hkv, int u,
                                           int hd) const {
    const int blk =
        __ldg(tbl + static_cast<long long>(b) * max_blocks + p / bs);
    return ((static_cast<long long>(blk) * bs + p % bs) * Hkv + u) * hd;
  }
};

// Let the combine launch be scheduled (programmatic dependent launch); it
// waits for this grid's completion before it reads the workspace.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One warp's cp.async copies of the kTile rows of src (K or V of kv head
// u of sequence b) from key p0, into dst (row stride ld elements); rows
// outside [first, last] are zeros and read nothing.
template <typename T, typename Rows>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          const Rows& rows, int b, int u,
                                          int Hkv, int hd, int p0, int first,
                                          int last, int lane) {
  constexpr int kVec = attn::Vec16<T>::n;
  const int chunks = hd / kVec;
  for (int i = lane; i < kTile * chunks; i += 32) {
    const int r = i / chunks, c = i - r * chunks, p = p0 + r;
    const bool ok = p >= first && p <= last;
    tc::cp_async16(dst + r * ld + c * kVec,
                   ok ? src + rows.row(b, p, Hkv, u, hd) + c * kVec : src,
                   ok ? 16 : 0);
  }
}

// The split's partial from its warps' states in shared memory (warp w:
// m, l at mls[2 g w + {0, g} + h], acc at accs[g hd w + f]), merged in
// warp order: rec = (acc[g * hd], m[g], l[g]).
__device__ __forceinline__ void write_partial(float* rec, const float* mls,
                                              const float* accs, int g,
                                              int hd) {
  const int gh = g * hd;
  for (int f = threadIdx.x; f < gh; f += kThreads) {
    const int h = f / hd;
    float m = attn::kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mls[2 * g * w + h]);
    float a = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float x = expf(mls[2 * g * w + h] - m);
      a = fmaf(accs[gh * w + f], x, a);
      l = fmaf(mls[2 * g * w + g + h], x, l);
    }
    rec[f] = a;
    if (f == h * hd) {
      rec[gh + h] = m;
      rec[gh + g + h] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores (f32, and bf16 outside the tensor-core form)
// ---------------------------------------------------------------------------

// 16 bytes of T in shared memory as f32.
__device__ __forceinline__ void smem16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void smem16(const bf16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// kAccVec = 4 consecutive elements of T in shared memory as f32.
__device__ __forceinline__ void smem4(const float* p, float* out) {
  smem16(p, out);
}

__device__ __forceinline__ void smem4(const bf16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), c = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = c.x; out[3] = c.y;
}

// Dynamic shared memory of the CUDA-core kernel, byte offsets: q as f32,
// the warps' K and V tiles, the probabilities (warp, key, head), the
// warps' partial outputs (warp, g * hd) and their m, l (warp, 2, g).  K/V
// rows are padded to an odd number of 16-byte chunks, so the 8 lanes of a
// 16-byte shared load hit 8 distinct bank groups.
struct CcSmem {
  int row, kv, p, acc, ml, total;
};

__host__ __device__ inline CcSmem cc_smem(int g, int hd, int esz) {
  const int chunks = hd * esz / 16;
  CcSmem s;
  s.row = 16 * (chunks + (chunks % 2 ? 2 : 1));
  s.kv = g * hd * 4;
  s.p = s.kv + kWarps * 2 * kTile * s.row;
  s.acc = s.p + kWarps * kTile * g * 4;
  s.ml = s.acc + kWarps * g * hd * 4;
  s.total = s.ml + kWarps * 2 * g * 4;
  return s;
}

// One CTA per (split, kv head u, sequence b): the split's f32 partial of
// every query head of u, into ws.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_cc(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ pos, float* __restrict__ ws,
                          Rows rows, int n_keys, int Hkv, int g, int hd,
                          int window, float scale) {
  constexpr int kVec = attn::Vec16<T>::n;
  allow_dependents();
  const int split = blockIdx.x, u = blockIdx.y, b = blockIdx.z;
  int first, last;
  visible(__ldg(pos + b), n_keys, window, &first, &last);
  const int s0 = split * kSplit;
  if (last < first || s0 > last || s0 + kSplit <= first) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const CcSmem lay = cc_smem(g, hd, sizeof(T));
  const int gh = g * hd, chunks = hd / kVec, ld = lay.row / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(smem + lay.kv) + warp * 2 * kTile * ld;
  T* vs = ks + kTile * ld;
  float* pw = reinterpret_cast<float*>(smem + lay.p) + warp * kTile * g;
  float* accs = reinterpret_cast<float*>(smem + lay.acc);
  float* mls = reinterpret_cast<float*>(smem + lay.ml);
  float* m_w = mls + warp * 2 * g;
  float* l_w = m_w + g;

  // this warp's keys p0 .. p0 + 31: K rows, then V rows, in flight
  const int p0 = s0 + warp * kTile;
  const bool live = p0 <= last && p0 + kTile > first;
  if (live) copy_tile(ks, ld, k, rows, b, u, Hkv, hd, p0, first, last, lane);
  tc::cp_async_commit();
  if (live) copy_tile(vs, ld, v, rows, b, u, Hkv, hd, p0, first, last, lane);
  tc::cp_async_commit();
  const T* qb = q + (static_cast<long long>(b) * Hkv + u) * gh;
  for (int i = threadIdx.x; i < gh; i += kThreads) qs[i] = attn::to_f32(qb[i]);
  for (int h = lane; h < g; h += 32) {
    m_w[h] = attn::kNegInf;
    l_w[h] = 0.f;
  }
  __syncthreads();  // q

  // The output elements this lane accumulates: chunk n is elements
  // f = 4 (lane + 32 n) .. f + 3 of the group's (g, hd), of head
  // own_h[n] (-1: past g * hd) from d = own_d[n].
  float acc[kMaxAcc][kAccVec];
  int own_h[kMaxAcc], own_d[kMaxAcc];
#pragma unroll
  for (int n = 0; n < kMaxAcc; ++n) {
    const int f = (lane + 32 * n) * kAccVec;
    own_h[n] = f < gh ? f / hd : -1;
    own_d[n] = f < gh ? f % hd : 0;
#pragma unroll
    for (int e = 0; e < kAccVec; ++e) acc[n][e] = 0.f;
  }

  tc::cp_async_wait<1>();  // this lane's K copies
  __syncwarp();            // ... and every lane's
  if (live) {
    const int p = p0 + lane;
    const bool valid = p >= first && p <= last;
    const T* krow = ks + lane * ld;
    for (int h0 = 0; h0 < g; h0 += kHeadGroup) {
      float s[kHeadGroup];
#pragma unroll
      for (int hh = 0; hh < kHeadGroup; ++hh) s[hh] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        float kf[kVec];
        smem16(krow + c * kVec, kf);
#pragma unroll
        for (int hh = 0; hh < kHeadGroup; ++hh) {
          if (h0 + hh < g) {
            float qf[kVec];
#pragma unroll
            for (int e = 0; e < kVec; e += 4)
              smem16(qs + (h0 + hh) * hd + c * kVec + e, qf + e);
#pragma unroll
            for (int e = 0; e < kVec; ++e) s[hh] = fmaf(qf[e], kf[e], s[hh]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < kHeadGroup; ++hh) {
        if (h0 + hh < g) {  // uniform over the warp
          const float sc = valid ? s[hh] * scale : attn::kNegInf;
          const float m = attn::warp_max(sc, 32);
          const float pr = valid ? expf(sc - m) : 0.f;
          pw[lane * g + h0 + hh] = pr;
          const float l = attn::warp_sum(pr, 32);
          if (lane == 0) {
            m_w[h0 + hh] = m;
            l_w[h0 + hh] = l;
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // V
  __syncwarp();            // ... and the probabilities
  if (live) {
    const int r_lo = max(first - p0, 0), r_hi = min(last - p0, kTile - 1);
    for (int r = r_lo; r <= r_hi; ++r) {
      const float* pr = pw + r * g;
      const T* vrow = vs + r * ld;
#pragma unroll
      for (int n = 0; n < kMaxAcc; ++n) {
        if (own_h[n] >= 0) {
          float vv[kAccVec];
          smem4(vrow + own_d[n], vv);
          const float pv = pr[own_h[n]];
#pragma unroll
          for (int e = 0; e < kAccVec; ++e)
            acc[n][e] = fmaf(pv, vv[e], acc[n][e]);
        }
      }
    }
  }

  float* acc_w = accs + warp * gh;
#pragma unroll
  for (int n = 0; n < kMaxAcc; ++n) {
    if (own_h[n] >= 0) {
#pragma unroll
      for (int e = 0; e < kAccVec; ++e)
        acc_w[(lane + 32 * n) * kAccVec + e] = acc[n][e];
    }
  }
  __syncthreads();
  write_partial(ws + ((static_cast<long long>(b) * Hkv + u) * gridDim.x +
                      split) * (gh + 2 * g),
                mls, accs, g, hd);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Dynamic shared memory of the tensor-core kernel, byte offsets: q as 16
// bf16 rows (rows g..15 zero), the warps' K and V tiles (rows padded by 8
// elements: ldmatrix rows on distinct banks), the warps' partial outputs
// (warp, g * HD) and their m, l (warp, 2, g).
template <int HD>
struct TcSmem {
  static constexpr int S = HD + 8;
  static constexpr int KV = 2 * 16 * S;
  static constexpr int ACC = KV + kWarps * 2 * 2 * kTile * S;
  static int total(int g) { return ACC + kWarps * g * (HD + 2) * 4; }
};

template <int HD, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_tc(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ pos, float* __restrict__ ws,
                          Rows rows, int n_keys, int Hkv, int g, int window,
                          float scale) {
  using L = TcSmem<HD>;
  constexpr int S = L::S;
  constexpr int DK = HD / 16;     // k16 steps of S = Q K^T
  constexpr int DN = HD / 8;      // n8 blocks of O
  constexpr int NB = kTile / 8;   // n8 blocks of S: the tile's keys
  allow_dependents();
  const int split = blockIdx.x, u = blockIdx.y, b = blockIdx.z;
  int first, last;
  visible(__ldg(pos + b), n_keys, window, &first, &last);
  const int s0 = split * kSplit;
  if (last < first || s0 > last || s0 + kSplit <= first) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int gh = g * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::KV) + warp * 2 * kTile * S;
  bf16* Vs = Ks + kTile * S;
  float* accs = reinterpret_cast<float*>(smem + L::ACC);
  float* mls = accs + kWarps * gh;

  // q (one group), then this warp's K rows and V rows (one group each)
  const bf16* qb = q + (static_cast<long long>(b) * Hkv + u) * gh;
  for (int c = threadIdx.x; c < 16 * (HD / 8); c += kThreads) {
    const int r = c / (HD / 8), d0 = (c % (HD / 8)) * 8;
    const bool ok = r < g;
    tc::cp_async16(Qs + r * S + d0, ok ? qb + r * HD + d0 : qb, ok ? 16 : 0);
  }
  tc::cp_async_commit();
  const int p0 = s0 + warp * kTile;
  const bool live = p0 <= last && p0 + kTile > first;
  if (live) copy_tile(Ks, S, k, rows, b, u, Hkv, HD, p0, first, last, lane);
  tc::cp_async_commit();
  if (live) copy_tile(Vs, S, v, rows, b, u, Hkv, HD, p0, first, last, lane);
  tc::cp_async_commit();
  tc::cp_async_wait<2>();
  __syncthreads();  // q
  unsigned qf[DK][4];  // the group's heads as the A rows
#pragma unroll
  for (int d = 0; d < DK; ++d)
    tc::ldmatrix_x4(qf[d], Qs + (lane & 15) * S + d * 16 + (lane >> 4) * 8);

  // this lane's heads gq and gq + 8; its output columns j * 8 + 2 tq (+1)
  float m_r[2] = {attn::kNegInf, attn::kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  tc::cp_async_wait<1>();  // K
  __syncwarp();
  unsigned pa[NB / 2][4];
  if (live) {
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d)
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned r[4];
        tc::ldmatrix_x4(r, Ks + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * S +
                               d * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * n2], qf[d], r[0], r[1]);
        tc::mma_bf16(s[2 * n2 + 1], qf[d], r[2], r[3]);
      }
    // key p0 + 8 n + 2 tq + (e & 1) of head gq + 8 (e >> 1)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + n * 8 + 2 * tq + (e & 1);
        const float x =
            p >= first && p <= last ? s[n][e] * scale : attn::kNegInf;
        s[n][e] = x;
        m_r[e >> 1] = fmaxf(m_r[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffffu, m_r[i], 1));
      m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffffu, m_r[i], 2));
    }
    // P = exp(s - m) in f32 (this lane's share of the row sums), then as
    // bf16 A fragments: keys 16 j .. 16 j + 15 are n8 blocks 2 j, 2 j + 1
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float e0 = expf(s[n][0] - m_r[0]), e1 = expf(s[n][1] - m_r[0]);
      const float e2 = expf(s[n][2] - m_r[1]), e3 = expf(s[n][3] - m_r[1]);
      l_r[0] += e0 + e1;
      l_r[1] += e2 + e3;
      pa[n / 2][(n & 1) * 2] = tc::pack_bf16(e0, e1);
      pa[n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(e2, e3);
    }
  }
  tc::cp_async_wait<0>();  // V
  __syncwarp();
  if (live) {
#pragma unroll
    for (int j = 0; j < NB / 2; ++j)
#pragma unroll
      for (int d2 = 0; d2 < DN / 2; ++d2) {
        unsigned r[4];
        tc::ldmatrix_x4_trans(r, Vs + (j * 16 + (lane & 15)) * S + d2 * 16 +
                                     (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * d2], pa[j], r[0], r[1]);
        tc::mma_bf16(acc[2 * d2 + 1], pa[j], r[2], r[3]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }

  // this warp's state to shared memory: heads gq and gq + 8 below g
  float* acc_w = accs + warp * gh;
  float* ml_w = mls + warp * 2 * g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = gq + 8 * i;
    if (h < g) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        acc_w[h * HD + j * 8 + 2 * tq] = acc[j][2 * i];
        acc_w[h * HD + j * 8 + 2 * tq + 1] = acc[j][2 * i + 1];
      }
      if (tq == 0) {
        ml_w[h] = m_r[i];
        ml_w[g + h] = l_r[i];
      }
    }
  }
  __syncthreads();
  write_partial(ws + ((static_cast<long long>(b) * Hkv + u) * gridDim.x +
                      split) * (gh + 2 * g),
                mls, accs, g, HD);
}

// ---------------------------------------------------------------------------
// The merge of a row's splits, and the launch
// ---------------------------------------------------------------------------

// One thread per (output element f, kv head u, sequence b): merge the
// live splits' partials in ascending order, out = acc / max(l, kMinDenom);
// zeros without a live split.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ ws,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int n_keys, int n_split, int Hkv, int g, int hd,
                         int window) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int u = blockIdx.y, b = blockIdx.z;
  const int gh = g * hd;
  if (f >= gh) return;
  int lo, hi;
  live_splits(__ldg(pos + b), n_keys, window, &lo, &hi);
  const long long stride = gh + 2 * g;
  const float* rec =
      ws + (static_cast<long long>(b) * Hkv + u) * n_split * stride;
  const int h = f / hd;
  float m = attn::kNegInf;
#pragma unroll 4
  for (int j = lo; j <= hi; ++j) m = fmaxf(m, rec[j * stride + gh + h]);
  float a = 0.f, l = 0.f;
#pragma unroll 4
  for (int j = lo; j <= hi; ++j) {
    const float* r = rec + j * stride;
    const float x = expf(r[gh + h] - m);
    a = fmaf(r[f], x, a);
    l = fmaf(r[gh + g + h], x, l);
  }
  out[(static_cast<long long>(b) * Hkv + u) * gh + f] =
      attn::from_f32<T>(a / fmaxf(l, attn::kMinDenom));
}

// Raise a kernel's dynamic shared memory limit once it is needed (per
// kernel instance: `configured` is the caller's static).
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, int* configured) {
  if (bytes <= *configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

template <typename T, typename Rows>
cudaError_t launch_cc(const T* q, const T* k, const T* v, const int* pos,
                      float* ws, Rows rows, int n_keys, int B, int Hkv,
                      int g, int hd, int window, float scale,
                      cudaStream_t st) {
  auto kern = decode_attention_split_cc<T, Rows>;
  static int configured = 48 * 1024;
  const int bytes = cc_smem(g, hd, sizeof(T)).total;
  const cudaError_t e = allow_smem(kern, bytes, &configured);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_splits(n_keys), Hkv, B), kThreads, bytes, st>>>(
      q, k, v, pos, ws, rows, n_keys, Hkv, g, hd, window, scale);
  return cudaGetLastError();
}

template <int HD, typename Rows>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v,
                      const int* pos, float* ws, Rows rows, int n_keys,
                      int B, int Hkv, int g, int window, float scale,
                      cudaStream_t st) {
  auto kern = decode_attention_split_tc<HD, Rows>;
  static int configured = 48 * 1024;
  const int bytes = TcSmem<HD>::total(g);
  const cudaError_t e = allow_smem(kern, bytes, &configured);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_splits(n_keys), Hkv, B), kThreads, bytes, st>>>(
      q, k, v, pos, ws, rows, n_keys, Hkv, g, window, scale);
  return cudaGetLastError();
}

// The split kernel: bf16 on the tensor cores where it takes the shape,
// else on the CUDA cores.
template <typename T, typename Rows>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* pos,
                         float* ws, Rows rows, int n_keys, int B, int Hkv,
                         int g, int hd, int window, cudaStream_t st) {
  const float scale = static_cast<float>(1.0 / std::sqrt(double(hd)));
  if constexpr (std::is_same<T, bf16>::value) {
    if (g <= kTcMaxGroup) {
      switch (hd) {
#define DECODE_TC(HD)                                                       \
  case HD:                                                                  \
    return launch_tc<HD>(q, k, v, pos, ws, rows, n_keys, B, Hkv, g, window, \
                         scale, st);
        DECODE_TC(16)
        DECODE_TC(32)
        DECODE_TC(64)
        DECODE_TC(128)
#undef DECODE_TC
        default:
          break;
      }
    }
  }
  return launch_cc(q, k, v, pos, ws, rows, n_keys, B, Hkv, g, hd, window,
                   scale, st);
}

bool shape_ok(int g, int hd, int vec) {
  return hd > 0 && hd <= kMaxHd && hd % vec == 0 && hd % kAccVec == 0 &&
         g > 0 && g * hd <= kMaxGroupWidth;
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, void* ws, Rows rows, int n_keys, int B, int Hq,
           int Hkv, int hd, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || n_keys <= 0 ||
      !shape_ok(Hq / Hkv, hd, attn::Vec16<T>::n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = Hq / Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  cudaError_t e = launch_split(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), p, w, rows, n_keys, B, Hkv, g, hd, window,
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g * hd + kThreads - 1) / kThreads, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_attention_combine<T>,
                         static_cast<const float*>(w), p,
                         static_cast<T*>(out), n_keys, n_splits(n_keys), Hkv,
                         g, hd, window);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split plan, for the wrapper's cross-check (kernels/decode_attention/
// ops.py mirrors it): keys a split, ...
extern "C" int decode_attention_split_keys() { return kSplit; }

// ... the f32 workspace of a call: a partial (acc[g * hd], m[g], l[g]) for
// every (sequence, kv head, split of the grid) ...
extern "C" long long decode_attention_workspace_floats(int B, int Hq,
                                                       int Hkv, int hd,
                                                       int n_keys) {
  const int g = Hq / Hkv;
  return static_cast<long long>(B) * Hkv * n_splits(n_keys) *
         (g * hd + 2 * g);
}

// ... and a row's live splits: lo_hi[0..1] = first, last (last < first
// when the row sees no key).
extern "C" int decode_attention_live_splits(int pos, int n_keys, int window,
                                            int* lo_hi) {
  live_splits(pos, n_keys, window, lo_hi, lo_hi + 1);
  return 0;
}

// q (B, Hq, hd); k/v (B, S, Hkv, hd); pos (B,) int32; out (B, Hq, hd);
// ws f32 of decode_attention_workspace_floats(B, Hq, Hkv, hd, S).
// All contiguous, one dtype (f32, or bf16 when is_bf16).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, void* ws, int B, int Hq,
                                       int Hkv, int S, int hd, int window,
                                       int is_bf16, void* stream) {
  DenseRows rows{S};
  if (is_bf16)
    return launch<bf16>(q, k, v, pos, out, ws, rows, S, B, Hq, Hkv, hd,
                        window, stream);
  return launch<float>(q, k, v, pos, out, ws, rows, S, B, Hq, Hkv, hd,
                       window, stream);
}

// q (B, Hq, hd); k/v (n_blocks, bs, Hkv, hd); tbl (B, max_blocks) int32;
// pos (B,) int32; out (B, Hq, hd); ws as above with n_keys = bs *
// max_blocks.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tbl,
    const void* pos, void* out, void* ws, int B, int Hq, int Hkv, int bs,
    int max_blocks, int hd, int window, int is_bf16, void* stream) {
  PagedRows rows{static_cast<const int*>(tbl), bs, max_blocks};
  const int n_keys = bs * max_blocks;
  if (is_bf16)
    return launch<bf16>(q, k, v, pos, out, ws, rows, n_keys, B, Hq, Hkv, hd,
                        window, stream);
  return launch<float>(q, k, v, pos, out, ws, rows, n_keys, B, Hq, Hkv, hd,
                       window, stream);
}
