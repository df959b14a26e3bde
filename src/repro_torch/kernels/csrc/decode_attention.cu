// GQA flash-decode, dense and paged, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/decode_attention/kernel.py
// _decode_kernel (decode_attention_call) and _paged_decode_kernel
// (paged_decode_attention_call): one query token per sequence attends over
// its KV cache, keys masked to pos-window < k_pos <= pos[b], softmax online
// in f32, output (B, Hq, hd) in the operands' type.
//
// What bounds it on an H100: KV bytes.  Each cached row is read once per
// layer and used for g = Hq/Hkv dot products, far below the ~295 flop/byte
// ridge.  At B=8, 1024 cached positions, 8 kv heads, hd 64 and bf16 one
// layer reads 16.8 MB: about 5 us at 3.35 TB/s.
//
// What the design does about it:
//  * one CTA per (b, kv head) serves all g query heads of its group, so each
//    K/V row leaves device memory once, not g times;
//  * the CTA walks only the keys its own sequence can see (lo..pos[b]), not
//    up to the batch-wide max(pos), and never a logical block past pos[b]:
//    the paged variant never touches the trash block through a stale entry;
//  * rows move as 16-byte loads, widened to f32 in shared memory.
// Not yet done (later work): split-KV across CTAs (only B*Hkv CTAs run),
// cp.async/TMA double buffering of the K/V tiles.
//
// The dense and paged kernels are one template: only the address of key
// row p differs, so on the same logical contents they are bitwise equal.

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 64;      // keys per shared-memory tile
constexpr int kMaxOut = 8;      // g*hd <= kThreads*kMaxOut = 1024
constexpr int kMaxHd = 128;

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
    const int blk = __ldg(tbl + static_cast<long long>(b) * max_blocks + p / bs);
    return ((static_cast<long long>(blk) * bs + p % bs) * Hkv + u) * hd;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, Rows rows, int n_keys, int Hkv,
                        int g, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int u = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ks = hd + 1;               // padded K row stride (bank spread)
  float* qs = smem;                    // (g, hd)
  float* Ks = qs + g * hd;             // (kTileK, hd+1)
  float* Vs = Ks + kTileK * ks;        // (kTileK, hd)
  float* Ss = Vs + kTileK * hd;        // (g, kTileK) scores, then p
  float* m_s = Ss + g * kTileK;        // (g,)
  float* l_s = m_s + g;                // (g,)
  float* a_s = l_s + g;                // (g,) alpha of the current tile

  const int Hq = Hkv * g;
  const int gh = g * hd;
  const T* qb = q + (static_cast<long long>(b) * Hq + u * g) * hd;
  for (int i = tid; i < gh; i += kThreads) qs[i] = attn::to_f32(qb[i]);
  if (tid < g) {
    m_s[tid] = attn::kNegInf;
    l_s[tid] = 0.f;
  }

  const int p_last = min(__ldg(pos + b), n_keys - 1);
  const int p_first = window > 0 ? max(0, p_last - window + 1) : 0;
  constexpr int V = attn::Vec16<T>::n;
  const int chunks = hd / V;
  const int warp = tid / 32, lane = tid % 32;

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  for (int t0 = p_first; t0 <= p_last; t0 += kTileK) {
    __syncthreads();  // previous tile fully consumed (and qs/m_s written)
    for (int c = tid; c < kTileK * chunks; c += kThreads) {
      const int r = c / chunks, d0 = (c % chunks) * V;
      const int p = t0 + r;
      float kv[V], vv[V];
      if (p <= p_last) {
        const long long off = rows.row(b, p, Hkv, u, hd) + d0;
        attn::load16(k + off, kv);
        attn::load16(v + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[r * ks + d0 + e] = kv[e];
        Vs[r * hd + d0 + e] = vv[e];
      }
    }
    __syncthreads();
    for (int i = tid; i < g * kTileK; i += kThreads) {
      const int h = i / kTileK, r = i % kTileK;
      float s = attn::kNegInf;
      if (t0 + r <= p_last) {
        const float* qh = qs + h * hd;
        const float* kr = Ks + r * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qh[d], kr[d], dot);
        s = dot * scale;
      }
      Ss[i] = s;
    }
    __syncthreads();
    for (int h = warp; h < g; h += kThreads / 32) {
      float* sh = Ss + h * kTileK;
      float mx = attn::kNegInf;
      for (int r = lane; r < kTileK; r += 32) mx = fmaxf(mx, sh[r]);
      mx = attn::warp_max(mx, 32);
      float m = m_s[h];
      const float alpha = attn::softmax_rescale(m, mx);
      float sum = 0.f;
      for (int r = lane; r < kTileK; r += 32) {
        const float p = expf(sh[r] - m);
        sh[r] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum, 32);
      if (lane == 0) {
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m;
        a_s[h] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < gh) {
        const int h = idx / hd, d = idx % hd;
        const float* ph = Ss + h * kTileK;
        float sum = 0.f;
        for (int r = 0; r < kTileK; ++r) sum = fmaf(ph[r], Vs[r * hd + d], sum);
        acc[i] = acc[i] * a_s[h] + sum;
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * Hq + u * g) * hd;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < gh) {
      const float l = fmaxf(l_s[idx / hd], attn::kMinDenom);
      ob[idx] = attn::from_f32<T>(acc[i] / l);
    }
  }
}

size_t smem_bytes(int g, int hd) {
  return sizeof(float) *
         (g * hd + kTileK * (hd + 1) + kTileK * hd + g * kTileK + 3 * g);
}

bool shape_ok(int g, int hd, int vec) {
  return hd > 0 && hd <= kMaxHd && hd % vec == 0 && g > 0 &&
         g * hd <= kThreads * kMaxOut;
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, Rows rows, int n_keys, int B, int Hq, int Hkv, int hd,
           int window, void* stream) {
  const int g = Hq / Hkv;
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || !shape_ok(g, hd, attn::Vec16<T>::n))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, hd);
  auto kern = decode_attention_kernel<T, Rows>;
  static size_t configured = 48 * 1024;  // per template instance
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), rows, n_keys, Hkv, g, hd, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, hd); k/v (B, S, Hkv, hd); pos (B,) int32; out (B, Hq, hd).
// All contiguous, one dtype (f32, or bf16 when is_bf16).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int Hq, int Hkv,
                                       int S, int hd, int window, int is_bf16,
                                       void* stream) {
  DenseRows rows{S};
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, rows, S, B, Hq, Hkv, hd,
                                 window, stream);
  return launch<float>(q, k, v, pos, out, rows, S, B, Hq, Hkv, hd, window,
                       stream);
}

// q (B, Hq, hd); k/v (n_blocks, bs, Hkv, hd); tbl (B, max_blocks) int32;
// pos (B,) int32; out (B, Hq, hd).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tbl,
    const void* pos, void* out, int B, int Hq, int Hkv, int bs,
    int max_blocks, int hd, int window, int is_bf16, void* stream) {
  PagedRows rows{static_cast<const int*>(tbl), bs, max_blocks};
  const int n_keys = bs * max_blocks;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, rows, n_keys, B, Hq, Hkv,
                                 hd, window, stream);
  return launch<float>(q, k, v, pos, out, rows, n_keys, B, Hq, Hkv, hd,
                       window, stream);
}
