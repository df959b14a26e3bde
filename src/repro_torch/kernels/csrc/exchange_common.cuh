// Device helpers shared by the two exchange kernels of the port
// (rd_allreduce.cu, fused_matmul_rd.cu): f32 <-> operand conversions,
// packed L2-only loads and stores for buffers other SMs write, the
// release/acquire flag protocol with a bounded spin, the LL packets and
// the epoch kept in device memory.
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

// LL packets (the paper's low-latency protocol): 8 bytes, the data in the
// low word and the call's flag value (epoch_value) in the high word,
// written and read as one
// scalar 64-bit access, which the PTX memory model makes single-copy
// atomic.  A receiver that sees the epoch sees the data stored with it:
// no fence, no barrier and no separate flag word.
__device__ __forceinline__ void store_packet(unsigned long long* p,
                                             unsigned data, unsigned epoch) {
  const unsigned long long v =
      (static_cast<unsigned long long>(epoch) << 32) | data;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_packet(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spin until the packet at p carries the flag value epoch and return its
// data; a wait past ~1 s traps, as wait_flag does.
__device__ __forceinline__ unsigned wait_packet(const unsigned long long* p,
                                                unsigned epoch) {
  const long long t0 = clock64();
  unsigned long long v = load_packet(p);
  while (static_cast<unsigned>(v >> 32) != epoch) {
    if (clock64() - t0 > kSpinLimit) __trap();
    v = load_packet(p);
  }
  return static_cast<unsigned>(v);
}

// The epoch of a launch, in device memory as kEpochWords 64-bit words, 128
// bytes apart, each (epoch << 32) | ticket (uint32 [ticket, epoch]; the
// epoch starts at 1).  The CTAs of piece index blockIdx.x use word
// blockIdx.x % kEpochWords, so every CTA that exchanges with a CTA uses its
// word, and no more than an eighth of the grid's CTAs meet on one address.
// One thread a CTA takes the CTA's ticket once: one atomic add both reads
// the word's epoch and counts the CTA, so no CTA counts itself before it
// has read.  epoch_ticket issues the add and returns at once (take it at
// the start: its round trip then overlaps the CTA's first put, and it is
// back before the put's fence, which would wait for it); epoch_value
// reads the result, and the CTA that made the word's count whole stores
// its next epoch with the ticket reset.  A CUDA graph that replays the
// launch reads the current epochs.  A kernel whose CTAs exchange with CTAs
// of any index (the fused GEMM's tiles) counts its whole grid on word 0
// instead: grid_epoch_ticket / grid_epoch_value.
constexpr int kEpochWords = 8;    // EPOCH_WORDS in rd_allreduce/ops.py
constexpr int kEpochStride = 32;  // uint32s between words

__device__ __forceinline__ unsigned* epoch_word(unsigned* ctl) {
  return ctl + (blockIdx.x % kEpochWords) * kEpochStride;
}

__device__ __forceinline__ unsigned long long take_ticket(unsigned* word) {
  unsigned long long old;
  asm volatile("atom.relaxed.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(word)
               : "memory");
  return old;
}

// The epoch a ticket read; the n-th of n tickets moves the word on.
__device__ __forceinline__ unsigned read_epoch(unsigned* word,
                                               unsigned long long old,
                                               unsigned n) {
  const unsigned epoch = static_cast<unsigned>(old >> 32);
  if (static_cast<unsigned>(old) == n - 1) {
    const unsigned next = epoch + 1 == (1u << 29) ? 1 : epoch + 1;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word),
                 "l"(static_cast<unsigned long long>(next) << 32)
                 : "memory");
  }
  return epoch;
}

__device__ __forceinline__ unsigned long long epoch_ticket(unsigned* ctl) {
  return take_ticket(epoch_word(ctl));
}

// The call's flag value, (epoch << 3) | word: never 0, which fresh flags
// and packets hold, and one word's values never equal another's, so a
// slot that another piece index wrote in an earlier call cannot match.
__device__ __forceinline__ unsigned epoch_value(unsigned* ctl,
                                                unsigned long long old) {
  const unsigned k = blockIdx.x % kEpochWords;
  const unsigned n = gridDim.y * gridDim.z *
                     ((gridDim.x - k + kEpochWords - 1) / kEpochWords);
  return read_epoch(epoch_word(ctl), old, n) << 3 | k;
}

__device__ __forceinline__ unsigned long long grid_epoch_ticket(
    unsigned* ctl) {
  return take_ticket(ctl);
}

// The call's flag value when every CTA of the grid counts on word 0:
// epoch << 3, the same on every CTA of a launch, never 0.
__device__ __forceinline__ unsigned grid_epoch_value(unsigned* ctl,
                                                     unsigned long long old) {
  return read_epoch(ctl, old, gridDim.x * gridDim.y * gridDim.z) << 3;
}

// Bring a line another SM will write and this one will poll into L2, so
// neither the put nor the first poll goes to device memory.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

}  // namespace exchange
