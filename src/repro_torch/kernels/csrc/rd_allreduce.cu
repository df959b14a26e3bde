// Recursive-doubling all-reduce over the slow axis of a virtual mesh, for
// Hopper (sm_90a): the paper's NVRAR inter-node phase (Algorithm 1,
// RD_inter) with its own mechanisms, device-initiated puts and, for small
// messages, its LL protocol (data and flag in one packet).
//
// Replaces the TPU kernel src/repro/kernels/rd_allreduce/kernel.py
// _rd_kernel (rd_all_reduce_kernel_call), whose remote DMAs and per-step
// barrier semaphores do the same exchange between TPU chips.
//
// What it computes.  x is (R, m), one row per rank of a (pods, fast) mesh,
// rank = pod * fast + f.  For pods = 2^k, at step s = 0..k-1 rank (p, f)
// adds the current partial of its peer (p ^ 2^s, f) to its own; after k
// steps every rank of a fast column holds the sum over the pods.  Each add
// is done in f32 and rounded to the operand type, and a + b == b + a, so
// every rank ends bitwise identical (and equal to the plain version).
//
// What bounds it on an H100.  At the decode message (16 KB a rank,
// llama3.2-1b at tp=8) latency: k round trips between SMs through L2, the
// launch and its tail; the bytes take nanoseconds.  At the prefill message
// (8 MB a rank) bytes: the exchange's own traffic through L2 and HBM.
//
// Two protocols, one per regime (ops.py picks by message size below
// LL_MAX_BYTES, a sweep of both on the card; PERF.md):
//
// LL (rd_allreduce_ll_kernel), small messages.  A packet is 8 bytes: 4 bytes of data
// (two bf16 or one f32) and the call's epoch, stored with one 64-bit
// relaxed store into the peer's receive buffer of that step (recv[s][peer],
// twice the payload).  The receiver polls its own packets with 64-bit
// loads until they carry the epoch: no fence, no barrier and no separate
// flag.  A thread keeps its elements in registers across all k steps: it
// adds what it received at step s, rounds to T, and that sum is its
// packet of step s+1; only the final sum goes to out.  The design does
// about the k round trips nothing can avoid and nothing else.
//
// Pieces and flags (rd_allreduce_kernel), large messages, where LL's
// doubled bytes cost more than its latency saves.  The grid is (pieces,
// R): CTA (g, r) owns piece g of rank r's row.  At step s it stores its
// piece into recv[s][peer], fences, and publishes flags[s][peer][g] =
// epoch with a release store; then it waits (acquire) for flags[s][r][g]
// == epoch and adds recv[s][r] to its partial.
//
// Why no race.  Every step has its own receive buffer (and flags), so a
// rank's step-(s+1) put can neither overwrite a buffer its peer still
// reads at step s nor satisfy its step-s wait (the role of the per-step
// semaphores and the parity double buffer of the TPU kernel).  Flags and
// packets carry the call's epoch and are never reset; launches on one
// stream do not overlap, so a buffer is reused only by a later call.
//
// The epoch lives in device memory, in eight 64-bit words that each hold
// a ticket beside it (exchange_common.cuh, epoch_ticket): one thread a CTA
// reads its word's epoch and takes the CTA's ticket in one atomic add, and
// the CTA that completes a word's count stores its next epoch, so no
// sequence number comes from the host and a captured CUDA graph replays
// the launch correctly.  The fused GEMM + RD kernel takes its flag value
// the same way from its own epoch words, beside its own flags.
//
// Co-residency.  CTAs spin on each other, so all must be resident at once:
// the wrapper never asks for more CTAs than the card holds at the kernel's
// occupancy, and the launch is a plain one on the port's one stream (see
// launch_grid); a wait that spins past ~1 s of clock64 cycles traps, so a
// protocol fault fails the run instead of hanging the card.  The receive
// buffers are the rows of one workspace, a table of peer buffers indexed
// by rank: on several GPUs the same body would take those rows from CUDA
// IPC pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "exchange_common.cuh"

namespace {

using namespace exchange;

constexpr int kThreads = 256;   // THREADS in rd_allreduce/ops.py

// x, out: (R, m_units) packs; recv: (steps, R, m_units) packs;
// flags: (steps, R, flag_stride) words.  Piece g of a row is sub-piece
// g % per_chunk of chunk g / per_chunk.  Thread 0 publishes and waits: it
// alone needs the epoch, whose ticket it issues first and reads at the
// first publish.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rd_allreduce_kernel(const T* x, T* out, T* recv, unsigned* flags,
                    unsigned* ctl, long long m_units, int pods, int fast,
                    int n_chunks, int per_chunk, int flag_stride) {
  using P = Pack<T, N>;
  unsigned long long ticket = 0;
  if (threadIdx.x == 0) ticket = epoch_ticket(ctl);
  const int r = blockIdx.y;
  const int g = blockIdx.x;
  const int R = gridDim.y;
  const int pod = r / fast, f = r % fast;

  const long long per_c = (m_units + n_chunks - 1) / n_chunks;
  const long long c_lo = min(m_units, (g / per_chunk) * per_c);
  const long long c_hi = min(m_units, c_lo + per_c);
  const long long sub = (c_hi - c_lo + per_chunk - 1) / per_chunk;
  const long long lo = min(c_hi, c_lo + (g % per_chunk) * sub);
  const long long hi = min(c_hi, lo + sub);

  const P* src = reinterpret_cast<const P*>(x) + r * m_units;
  P* dst = reinterpret_cast<P*>(out) + r * m_units;
  P* rbuf = reinterpret_cast<P*>(recv);

  int steps = 0;
  while ((1 << steps) < pods) ++steps;
  unsigned seq = 0;
  if (steps == 0) {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) dst[i] = src[i];
    if (threadIdx.x == 0) epoch_value(ctl, ticket);
  }
  for (int s = 0; s < steps; ++s) {
    const int peer = (pod ^ (1 << s)) * fast + f;
    P* to_peer = rbuf + (static_cast<long long>(s) * R + peer) * m_units;
    const P* mine = rbuf + (static_cast<long long>(s) * R + r) * m_units;
    // put: this piece of my partial into the peer's step-s buffer
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      store_cg(to_peer + i, src[i]);
    if (s == 0 && threadIdx.x == 0) seq = epoch_value(ctl, ticket);
    publish(flags + (static_cast<long long>(s) * R + peer) * flag_stride + g,
            seq);
    cta_wait(flags + (static_cast<long long>(s) * R + r) * flag_stride + g,
             seq);
    // each thread adds the elements it put, so src (== dst after step 0)
    // is only ever read by the thread that wrote it
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      dst[i] = add(src[i], load_cg(mine + i));
    src = dst;
  }
}

// Elements of T in a packet's 4 data bytes.
template <typename T>
constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));

// Data word p of a row of m elements (zeros past m).  WORD: the row is
// 4-byte aligned and m fills whole words, so it is read as words.
template <typename T, bool WORD>
__device__ __forceinline__ unsigned load_word(const T* row, long long p,
                                              long long m) {
  if (WORD) return reinterpret_cast<const unsigned*>(row)[p];
  T v[kPerWord<T>];
#pragma unroll
  for (int j = 0; j < kPerWord<T>; ++j) {
    const long long i = p * kPerWord<T> + j;
    v[j] = i < m ? row[i] : from_f<T>(0.f);
  }
  unsigned w;
  memcpy(&w, v, 4);
  return w;
}

template <typename T, bool WORD>
__device__ __forceinline__ void store_word(T* row, long long p, long long m,
                                           unsigned w) {
  if (WORD) {
    reinterpret_cast<unsigned*>(row)[p] = w;
    return;
  }
  T v[kPerWord<T>];
  memcpy(v, &w, 4);
#pragma unroll
  for (int j = 0; j < kPerWord<T>; ++j) {
    const long long i = p * kPerWord<T> + j;
    if (i < m) row[i] = v[j];
  }
}

// a + b for the elements of two data words, in f32, one rounding to T.
template <typename T>
__device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
  Pack<T, kPerWord<T>> pa, pb;
  memcpy(&pa, &a, 4);
  memcpy(&pb, &b, 4);
  const Pack<T, kPerWord<T>> c = add(pa, pb);
  unsigned w;
  memcpy(&w, &c, 4);
  return w;
}

// The data words of one round: packets base + t + j * kThreads < hi.
template <typename T, bool WORD, int PPT>
__device__ __forceinline__ void load_round(unsigned (&d)[PPT], const T* src,
                                           long long base, long long hi,
                                           long long m) {
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const long long p = base + threadIdx.x + j * kThreads;
    d[j] = p < hi ? load_word<T, WORD>(src, p, m) : 0u;
  }
}

// x, out: (R, m) elements; recv: (steps, R, n_pk) packets, zero at first
// use.  CTA (g, r) owns a contiguous range of rank r's packets and walks it
// in rounds of kThreads * PPT; thread t of a round owns packets t, t +
// kThreads, ... (a warp's stores cover 256 contiguous bytes).  While the
// first round's words load, the CTA prefetches its receive slots into L2
// and thread 0 takes the CTA's epoch (needed before the first put).
template <typename T, bool WORD, int PPT>
__global__ void __launch_bounds__(kThreads)
rd_allreduce_ll_kernel(const T* x, T* out, unsigned long long* recv, unsigned* ctl,
             long long m, long long n_pk, int pods, int fast) {
  __shared__ unsigned s_epoch;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int pod = r / fast, f = r % fast;
  int steps = 0;
  while ((1 << steps) < pods) ++steps;

  const long long per = (n_pk + gridDim.x - 1) / gridDim.x;
  const long long lo = min(n_pk, blockIdx.x * per);
  const long long hi = min(n_pk, lo + per);
  const T* src = x + r * m;
  T* dst = out + r * m;
  unsigned d[PPT];
  load_round<T, WORD, PPT>(d, src, lo, hi, m);
  // this thread's receive slots of the first round, one prefetch a line
  for (int s = 0; s < steps; ++s) {
    const unsigned long long* mine =
        recv + (static_cast<long long>(s) * R + r) * n_pk;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const long long p = lo + threadIdx.x + j * kThreads;
      if (p < hi && p % 16 == 0) prefetch_l2(mine + p);
    }
  }
  if (threadIdx.x == 0) s_epoch = epoch_value(ctl, epoch_ticket(ctl));
  __syncthreads();
  const unsigned epoch = s_epoch;
  for (long long base = lo; base < hi; base += kThreads * PPT) {
    if (base != lo) load_round<T, WORD, PPT>(d, src, base, hi, m);
    for (int s = 0; s < steps; ++s) {
      const int peer = (pod ^ (1 << s)) * fast + f;
      unsigned long long* to_peer =
          recv + (static_cast<long long>(s) * R + peer) * n_pk;
      const unsigned long long* mine =
          recv + (static_cast<long long>(s) * R + r) * n_pk;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const long long p = base + threadIdx.x + j * kThreads;
        if (p < hi) store_packet(to_peer + p, d[j], epoch);
      }
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const long long p = base + threadIdx.x + j * kThreads;
        if (p < hi) d[j] = add_word<T>(d[j], wait_packet(mine + p, epoch));
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const long long p = base + threadIdx.x + j * kThreads;
      if (p < hi) store_word<T, WORD>(dst, p, m, d[j]);
    }
  }
}

// A plain launch: co-residency holds without the cooperative launch's
// check (measured 0.2-0.3 us a call slower on an H100; PERF.md), because
// the wrapper never asks for more CTAs than the card holds resident at
// this kernel's occupancy (ops.py::_resident_ctas) and the port issues
// every kernel on one stream, so the launch starts on an idle card and
// no other grid takes SMs while this one runs.
cudaError_t launch_grid(const void* kern, dim3 grid, void** args,
                        void* stream) {
  const cudaError_t e =
      cudaLaunchKernel(kern, grid, dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int N>
int launch(const void* x, void* out, void* recv, void* flags, void* ctl,
           long long m, int R, int pods, int n_chunks, int per_chunk,
           int flag_stride, void* stream) {
  if (R <= 0 || pods <= 0 || R % pods || n_chunks <= 0 || per_chunk <= 0 ||
      m % N || n_chunks * per_chunk > flag_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  T* rp = static_cast<T*>(recv);
  unsigned* fp = static_cast<unsigned*>(flags);
  unsigned* cp = static_cast<unsigned*>(ctl);
  long long m_units = m / N;
  int fast = R / pods;
  void* args[] = {&xp, &op, &rp, &fp, &cp, &m_units, &pods, &fast,
                  &n_chunks, &per_chunk, &flag_stride};
  return static_cast<int>(
      launch_grid(reinterpret_cast<void*>(rd_allreduce_kernel<T, N>),
                  dim3(n_chunks * per_chunk, R), args, stream));
}

template <typename T, bool WORD, int PPT>
int launch_ll(const void* x, void* out, void* recv, void* ctl, long long m,
              int R, int pods, int pieces, void* stream) {
  if (R <= 0 || pods <= 0 || R % pods || pieces <= 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  unsigned long long* rp = static_cast<unsigned long long*>(recv);
  unsigned* cp = static_cast<unsigned*>(ctl);
  long long n_pk = (m + kPerWord<T> - 1) / kPerWord<T>;
  int fast = R / pods;
  void* args[] = {&xp, &op, &rp, &cp, &m, &n_pk, &pods, &fast};
  return static_cast<int>(
      launch_grid(reinterpret_cast<void*>(rd_allreduce_ll_kernel<T, WORD, PPT>),
                  dim3(pieces, R), args, stream));
}

template <int PPT>
int launch_ll_ppt(const void* x, void* out, void* recv, void* ctl,
                  long long m, int R, int pods, int pieces, int is_bf16,
                  int word, void* stream) {
  if (is_bf16)
    return word ? launch_ll<__nv_bfloat16, true, PPT>(
                      x, out, recv, ctl, m, R, pods, pieces, stream)
                : launch_ll<__nv_bfloat16, false, PPT>(
                      x, out, recv, ctl, m, R, pods, pieces, stream);
  return launch_ll<float, true, PPT>(x, out, recv, ctl, m, R, pods, pieces,
                                     stream);
}

template <class K>
int max_ctas(K kern) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per_sm;
}

}  // namespace

// Pieces and flags.  x, out: (R, m) contiguous rows of f32 (or bf16 when
// is_bf16), 16-byte aligned rows when vec; recv: (steps, R, m) of the
// same type; flags: (steps, R, flag_stride) uint32, zero at first use;
// ctl: the epoch words (uint32 [8][32]).  Grid (n_chunks * per_chunk, R)
// on `stream`.
extern "C" int rd_allreduce_launch(const void* x, void* out, void* recv,
                                   void* flags, void* ctl, long long m,
                                   int R, int pods, int n_chunks,
                                   int per_chunk, int flag_stride,
                                   int is_bf16, int vec, void* stream) {
  if (is_bf16)
    return vec ? launch<__nv_bfloat16, 8>(x, out, recv, flags, ctl, m, R,
                                          pods, n_chunks, per_chunk,
                                          flag_stride, stream)
               : launch<__nv_bfloat16, 1>(x, out, recv, flags, ctl, m, R,
                                          pods, n_chunks, per_chunk,
                                          flag_stride, stream);
  return vec ? launch<float, 4>(x, out, recv, flags, ctl, m, R, pods,
                                n_chunks, per_chunk, flag_stride, stream)
             : launch<float, 1>(x, out, recv, flags, ctl, m, R, pods,
                                n_chunks, per_chunk, flag_stride, stream);
}

// LL.  x, out as above (word: 4-byte aligned rows of whole words); recv:
// (steps, R, ceil(m / elements a word)) 8-byte packets, zero at first use;
// ctl as above.  Grid (pieces, R).
extern "C" int rd_allreduce_ll_launch(const void* x, void* out, void* recv,
                                      void* ctl, long long m, int R,
                                      int pods, int pieces, int is_bf16,
                                      int word, int ppt, void* stream) {
  switch (ppt) {
    case 1: return launch_ll_ppt<1>(x, out, recv, ctl, m, R, pods, pieces,
                                    is_bf16, word, stream);
    case 2: return launch_ll_ppt<2>(x, out, recv, ctl, m, R, pods, pieces,
                                    is_bf16, word, stream);
    case 4: return launch_ll_ppt<4>(x, out, recv, ctl, m, R, pods, pieces,
                                    is_bf16, word, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of one launch that the card can hold resident at once (all SMs at
// the kernel's occupancy), or minus a CUDA error code.  ll: the LL kernel
// at 4 packets a thread, its most registers (vec then means whole words).
extern "C" int rd_allreduce_max_ctas(int is_bf16, int vec, int ll) {
  using bf = __nv_bfloat16;
  if (ll)
    return is_bf16 ? (vec ? max_ctas(rd_allreduce_ll_kernel<bf, true, 4>)
                          : max_ctas(rd_allreduce_ll_kernel<bf, false, 4>))
                   : max_ctas(rd_allreduce_ll_kernel<float, true, 4>);
  if (is_bf16)
    return vec ? max_ctas(rd_allreduce_kernel<bf, 8>)
               : max_ctas(rd_allreduce_kernel<bf, 1>);
  return vec ? max_ctas(rd_allreduce_kernel<float, 4>)
             : max_ctas(rd_allreduce_kernel<float, 1>);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
