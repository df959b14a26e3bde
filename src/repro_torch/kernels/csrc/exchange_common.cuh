// Device helpers shared by the two exchange kernels of the port
// (rd_allreduce.cu, fused_matmul_rd.cu): f32 <-> operand conversions,
// packed L2-only loads and stores for buffers other SMs write, and the
// release/acquire flag protocol with a bounded spin.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace exchange {

constexpr long long kSpinLimit = 2000000000LL;  // clock64 cycles, ~1 s

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements moved as one load or store (16 bytes when N * sizeof(T) == 16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// a + b elementwise in f32, one rounding to T.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> add(const Pack<T, N>& a,
                                          const Pack<T, N>& b) {
  Pack<T, N> c;
#pragma unroll
  for (int i = 0; i < N; ++i) c.v[i] = from_f<T>(to_f(a.v[i]) + to_f(b.v[i]));
  return c;
}

// Word of the same size as P, for the L2-only (.cg) loads and stores: the
// receive buffers are written by other SMs, and L1 is not coherent.
template <int Bytes> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

template <typename P>
__device__ __forceinline__ P load_cg(const P* p) {
  using W = typename Word<sizeof(P)>::type;
  W w = __ldcg(reinterpret_cast<const W*>(p));
  P out;
  memcpy(&out, &w, sizeof(P));
  return out;
}

template <typename P>
__device__ __forceinline__ void store_cg(P* p, const P& v) {
  using W = typename Word<sizeof(P)>::type;
  W w;
  memcpy(&w, &v, sizeof(P));
  __stcg(reinterpret_cast<W*>(p), w);
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spin until *p == seq; a wait past ~1 s traps, so a protocol fault fails
// the run instead of hanging the card.
__device__ __forceinline__ void wait_flag(const unsigned* p, unsigned seq) {
  const long long t0 = clock64();
  while (load_acquire(p) != seq) {
    if (clock64() - t0 > kSpinLimit) __trap();
    __nanosleep(32);
  }
}

// Make this CTA's puts visible at gpu scope, then publish *flag = seq.
__device__ __forceinline__ void publish(unsigned* flag, unsigned seq) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag, seq);
}

// One thread of the CTA waits for *flag == seq, then the whole CTA goes on.
__device__ __forceinline__ void cta_wait(const unsigned* flag, unsigned seq) {
  if (threadIdx.x == 0) wait_flag(flag, seq);
  __syncthreads();
}

}  // namespace exchange
