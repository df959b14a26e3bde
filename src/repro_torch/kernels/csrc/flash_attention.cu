// Blocked causal/windowed flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// _flash_kernel (flash_attention_call): q (B, Hq, Sq, hd) attends over
// k/v (B, Hkv, Skv, hd) with query head h reading kv head h // g, keys
// masked by k < Skv (ragged lengths), the causal mask and the sliding
// window, softmax online in f32, output in the operands' type.
//
// What bounds it on an H100: operations.  At the main path's prefill shape
// (B=8, 32 q heads, 512 tokens, hd 64) the causal half of QK^T and PV is
// 8.6 GFLOP against 42 MB of q/k/v/o, about 200 flop/byte; the tensor-core
// bound and the byte bound are both about 10 us there.
//
// Common to both forms: one CTA per (b, q head, 64-row q tile) keeps its q
// tile, one 64-key K/V tile and the f32 online-softmax state on chip, so
// the (Sq, Skv) score matrix never reaches device memory; K/V tiles wholly
// above the causal diagonal or outside the window are never loaded; GQA is
// an index (h // g), never an expanded copy of K/V.
//
// bf16, on the tensor cores (the FlashAttention-2 shape): 4 warps, each
// owning 16 query rows.  Q, K and V stay bf16 in shared memory, K/V tiles
// double-buffered by 16-byte cp.async (rows past Skv zero-filled); Q
// fragments are loaded once (ldmatrix), K with ldmatrix and V with
// ldmatrix.trans; S = Q K^T and O = P V run as mma.sync m16n8k16 with f32
// accumulators held in registers; the online softmax works on the S
// fragments (row max and row sum over the 4 lanes of a row by shuffles).
// P is rounded to bf16 for the PV product (the plain version keeps it
// f32; the sum l is taken over the f32 values).  The mask is applied only
// on tiles that straddle Skv, the causal diagonal or the window's edge.
// The CTAs of the longest rows are issued first.
//
// f32: on the CUDA cores (4x4 register tiles per thread, 256 threads),
// which keeps f32 operands exact (no TF32).
//
// Operands may be strided (the model passes (B, S, H, hd) views transposed
// to (B, H, S, hd)); only the last dimension must be contiguous, and the
// wrapper checks that rows start on 16-byte boundaries.

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty+16i, tx cols tx+16j
constexpr int kBQ = 64;
constexpr int kBK = 64;

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so, int g,
                       int Sq, int Skv, int causal, int window, float scale) {
  constexpr int QS = HD + 1, KS = HD + 1, PS = kBK + 1;  // padded strides
  constexpr int DJ = HD / 16;
  constexpr int V = attn::Vec16<T>::n;
  constexpr int CH = HD / V;
  extern __shared__ float smem[];
  float* Qs = smem;              // (kBQ, HD+1)
  float* Ks = Qs + kBQ * QS;     // (kBK, HD+1)
  float* Vs = Ks + kBK * KS;     // (kBK, HD)
  float* Ps = Vs + kBK * HD;     // (kBQ, kBK+1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / g) * sk.h;
  const T* vb = v + b * sv.b + (h / g) * sv.h;

  for (int c = tid; c < kBQ * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * V;
    float x[V];
    if (q0 + r < Sq) {
      attn::load16(qb + (q0 + r) * sq.s + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) Qs[r * QS + d0 + e] = x[e];
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // K tiles that hold at least one key some row of this q tile may see.
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Vs/Ps reads are done
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int r = c / CH, d0 = (c % CH) * V;
      float kx[V], vx[V];
      if (k0 + r < Skv) {
        attn::load16(kb + (k0 + r) * sk.s + d0, kx);
        attn::load16(vb + (k0 + r) * sv.s + d0, vx);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[r * KS + d0 + e] = kx[e];
        Vs[r * HD + d0 + e] = vx[e];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = attn::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : attn::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = attn::warp_max(mx, 16);  // the 16 lanes of row ty+16i
      const float alpha = attn::softmax_rescale(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum, 16);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], attn::kMinDenom);
    T* orow = o + b * so.b + h * so.h + r * so.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = attn::from_f32<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 query rows = kBQ
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcSmem {
  static constexpr int S = HD + 8;  // padded row stride: ldmatrix rows on
                                    // distinct banks
  static constexpr int TILE = kBK * S;
  static constexpr int BYTES = 2 * (kBQ * S + 4 * TILE);  // Q, 2 x (K, V)
};

// Issue the 16-byte copies of `rows` rows of hd elements from src (row
// stride ld) into dst (stride S); rows at or past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void tc_copy_rows(bf16* dst, const bf16* src,
                                             long long ld, int rows,
                                             int valid) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < rows * CH; c += kTcThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * TcSmem<HD>::S + d0, ok ? src + r * ld + d0 : src,
                   ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          int g, int Sq, int Skv, int causal, int window,
                          float scale) {
  using L = TcSmem<HD>;
  constexpr int S = L::S;
  constexpr int DK = HD / 16;   // k16 steps of Q K^T
  constexpr int DN = HD / 8;    // n8 blocks of O
  constexpr int NB = kBK / 8;   // n8 blocks of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (kBQ, S)
  bf16* KVs = Qs + kBQ * S;                       // [buf][K, V] (kBK, S)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const bf16* kb = k + b * sk.b + (h / g) * sk.h;
  const bf16* vb = v + b * sv.b + (h / g) * sv.h;

  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  tc_copy_rows<HD>(Qs, q + b * sq.b + h * sq.h + q0 * sq.s, sq.s, kBQ,
                   Sq - q0);
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    bf16* Ks = KVs + buf * 2 * L::TILE;
    tc_copy_rows<HD>(Ks, kb + k0 * sk.s, sk.s, kBK, Skv - k0);
    tc_copy_rows<HD>(Ks + L::TILE, vb + k0 * sv.s, sv.s, kBK, Skv - k0);
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[DK][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int d = 0; d < DK; ++d)
    tc::ldmatrix_x4(qf[d], Qs + (warp * 16 + (lane & 15)) * S + d * 16 +
                               (lane >> 4) * 8);

  // this warp's query rows: r_lo = q0 + 16 warp + gq and r_lo + 8
  const int r_lo = q0 + warp * 16 + gq;
  const float sl2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
  float m_r[2] = {attn::kNegInf, attn::kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    const int k0 = kt * kBK;
    __syncthreads();  // the other buffer's reads (tile kt-1) are done
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile kt landed
    __syncthreads();
    const bf16* Ks = KVs + buf * 2 * L::TILE;
    const bf16* Vs = Ks + L::TILE;

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

    // the mask, only where this warp's 16 rows meet an edge of the tile
    const int w_lo = q0 + warp * 16, w_hi = w_lo + 15;
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > w_lo) ||
                      (window > 0 && k0 <= w_hi - window);
    float mx[2] = {attn::kNegInf, attn::kNegInf};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
          const int qpos = r_lo + (e >> 1) * 8;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : attn::kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // P = exp2(s - m) in f32 (this lane's share of the row sums), then as
    // bf16 A fragments: keys 16j..16j+15 are n8 blocks 2j and 2j+1
    unsigned pa[NB / 2][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float p0 = exp2f(s[n][0] - m_r[0]);
      const float p1 = exp2f(s[n][1] - m_r[0]);
      const float p2 = exp2f(s[n][2] - m_r[1]);
      const float p3 = exp2f(s[n][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = tc::pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
    }
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
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_lo + i * 8;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l, attn::kMinDenom);
    bf16* orow = o + b * so.b + h * so.h + r * so.s;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<unsigned*>(orow + j * 8 + 2 * tq) =
          tc::pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

template <int HD>
int launch_tc_hd(const void* q, const void* k, const void* v, void* o,
                 const Strides* st, int B, int Hq, int g, int Sq, int Skv,
                 int causal, int window, void* stream) {
  constexpr int smem = TcSmem<HD>::BYTES;
  auto kern = flash_attention_tc_kernel<HD>;
  static bool configured = false;  // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st[0], st[1],
      st[2], st[3], g, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              const Strides* st, int B, int Hq, int g, int Sq, int Skv,
              int causal, int window, void* stream) {
  constexpr size_t smem = sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) +
                                           kBK * HD + kBQ * (kBK + 1));
  auto kern = flash_attention_kernel<T, HD>;
  static bool configured = false;  // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], g, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes the tensor-core kernel, f32 the CUDA-core one.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int Hq, int g, int Sq, int Skv, int hd,
           int causal, int window, void* stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  switch (hd) {
#define FLASH_HD(HD)                                                        \
  case HD:                                                                  \
    if constexpr (kTc)                                                      \
      return launch_tc_hd<HD>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,    \
                              window, stream);                              \
    else                                                                    \
      return launch_hd<T, HD>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,    \
                              window, stream);
    FLASH_HD(16)
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(128)
#undef FLASH_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), o (B, Hq, Sq, hd), one dtype
// (f32, or bf16 when is_bf16), each with unit stride on hd.  `strides`
// holds 12 element strides: (batch, head, seq) of q, k, v and o in turn.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int hd,
                                      int causal, int window, int is_bf16,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int g = Hq / Hkv;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, st, B, Hq, g, Sq, Skv, hd,
                                 causal, window, stream);
  return launch<float>(q, k, v, o, st, B, Hq, g, Sq, Skv, hd, causal, window,
                       stream);
}
