// Recursive-doubling all-reduce over the slow axis of a virtual mesh, for
// Hopper (sm_90a): the paper's NVRAR inter-node phase (Algorithm 1,
// RD_inter) with its own mechanism, device-initiated puts and
// sequence-number flags.
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
// The mechanism.  One launch per all-reduce, all k steps inside it.  The
// grid is (pieces, R): CTA (g, r) owns piece g of rank r's row.  At step s
// it stores its piece into the peer's receive buffer of that step
// (recv[s][peer]), fences, and publishes flags[s][peer][g] = seq with a
// release store; then it waits (acquire) for flags[s][r][g] == seq and adds
// recv[s][r] to its partial.  The receive buffers are the rows of one
// workspace, a table of peer buffers indexed by rank: on several GPUs the
// same body would take those rows from CUDA IPC pointers.
//
// Why no race.  Every step has its own receive buffer and its own flags,
// so a fast rank's step-(s+1) put can neither overwrite a buffer its peer
// still reads at step s nor satisfy its step-s wait (the role of the
// per-step semaphores and the parity double buffer of the TPU kernel).
// Flags carry the call's sequence number and are never reset; launches on
// one stream do not overlap, so a buffer is reused only by a later call.
//
// Co-residency.  CTAs spin on each other, so all must be resident at once:
// the launch is cooperative (cudaLaunchCooperativeKernel refuses a grid
// that does not fit), and a wait that spins past ~1 s of clock64 cycles
// traps, so a protocol fault fails the run instead of hanging the card.
//
// What bounds it on an H100: bytes.  Per step and rank the piece is read
// twice and the received copy once, and the put and the new partial are
// written: 5 m elements per step against the 4 m the exchange must move
// (a later PR can fuse step s's add with step s+1's put).  At the decode
// message (16 KB a rank) it is bound by launch and flag latency instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exchange_common.cuh"

namespace {

using namespace exchange;

constexpr int kThreads = 256;  // THREADS in rd_allreduce/ops.py

// x, out: (R, m_units) packs; recv: (steps, R, m_units) packs;
// flags: (steps, R, flag_stride) words.  Piece g of a row is sub-piece
// g % per_chunk of chunk g / per_chunk.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rd_allreduce_kernel(const T* x, T* out, T* recv, unsigned* flags,
                    long long m_units, int pods, int fast, int n_chunks,
                    int per_chunk, int flag_stride, unsigned seq) {
  using P = Pack<T, N>;
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
  if (steps == 0) {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) dst[i] = src[i];
    return;
  }
  for (int s = 0; s < steps; ++s) {
    const int peer = (pod ^ (1 << s)) * fast + f;
    P* to_peer = rbuf + (static_cast<long long>(s) * R + peer) * m_units;
    const P* mine = rbuf + (static_cast<long long>(s) * R + r) * m_units;
    // put: this piece of my partial into the peer's step-s buffer
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      store_cg(to_peer + i, src[i]);
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

template <typename T, int N>
int launch(const void* x, void* out, void* recv, void* flags, long long m,
           int R, int pods, int n_chunks, int per_chunk, int flag_stride,
           unsigned seq, void* stream) {
  if (R <= 0 || pods <= 0 || R % pods || n_chunks <= 0 || per_chunk <= 0 ||
      m % N || n_chunks * per_chunk > flag_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rd_allreduce_kernel<T, N>;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  T* rp = static_cast<T*>(recv);
  unsigned* fp = static_cast<unsigned*>(flags);
  long long m_units = m / N;
  int fast = R / pods;
  void* args[] = {&xp, &op, &rp, &fp, &m_units, &pods, &fast,
                  &n_chunks, &per_chunk, &flag_stride, &seq};
  dim3 grid(n_chunks * per_chunk, R);
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kern), grid, dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int max_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rd_allreduce_kernel<T, N>, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per_sm;
}

}  // namespace

// x, out: (R, m) contiguous rows of f32 (or bf16 when is_bf16), 16-byte
// aligned rows when vec; recv: (steps, R, m) of the same type; flags:
// (steps, R, flag_stride) uint32, zero at first use.  Grid (n_chunks *
// per_chunk, R), launched cooperatively on `stream`.
extern "C" int rd_allreduce_launch(const void* x, void* out, void* recv,
                                   void* flags, long long m, int R, int pods,
                                   int n_chunks, int per_chunk,
                                   int flag_stride, unsigned seq, int is_bf16,
                                   int vec, void* stream) {
  if (is_bf16)
    return vec ? launch<__nv_bfloat16, 8>(x, out, recv, flags, m, R, pods,
                                          n_chunks, per_chunk, flag_stride,
                                          seq, stream)
               : launch<__nv_bfloat16, 1>(x, out, recv, flags, m, R, pods,
                                          n_chunks, per_chunk, flag_stride,
                                          seq, stream);
  return vec ? launch<float, 4>(x, out, recv, flags, m, R, pods, n_chunks,
                                per_chunk, flag_stride, seq, stream)
             : launch<float, 1>(x, out, recv, flags, m, R, pods, n_chunks,
                                per_chunk, flag_stride, seq, stream);
}

// CTAs of one launch that the card can hold resident at once (all SMs at
// the kernel's occupancy), or minus a CUDA error code.
extern "C" int rd_allreduce_max_ctas(int is_bf16, int vec) {
  if (is_bf16) return vec ? max_ctas<__nv_bfloat16, 8>()
                          : max_ctas<__nv_bfloat16, 1>();
  return vec ? max_ctas<float, 4>() : max_ctas<float, 1>();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
