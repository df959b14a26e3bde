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
// What the design does about it: one CTA per (b, q head, 64-row q tile)
// keeps its q tile, one 64-key K/V tile and the f32 online-softmax state
// on chip, so the (Sq, Skv) score matrix never reaches device memory; K/V
// tiles wholly above the causal diagonal or outside the window are never
// loaded; GQA is an index (h // g), never an expanded copy of K/V.  The
// products run on the CUDA cores in f32 (4x4 register tiles per thread),
// which keeps f32 operands exact: this first version is far from the
// tensor-core bound.  wgmma on bf16 tiles fed by TMA is later work.
//
// Operands may be strided (the model passes (B, S, H, hd) views transposed
// to (B, H, S, hd)); only the last dimension must be contiguous.

#include <cmath>

#include "attention_common.cuh"

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int Hq, int g, int Sq, int Skv, int hd,
           int causal, int window, void* stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,
                              window, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,
                              window, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,
                              window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, st, B, Hq, g, Sq, Skv, causal,
                               window, stream);
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
