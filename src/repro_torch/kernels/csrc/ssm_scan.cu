// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py _ssm_kernel
// (ssm_scan_call): per sequence n, channel c and state s, over t = 0..T-1,
//     h[c,s] <- exp(A[c,s] dt_t[c]) h[c,s] + (dt_t[c] x_t[c]) B_t[s]
//     y_t[c]  = sum_s h[c,s] C_t[s]
// with x/dt (N, T, Ci), B/C (N, T, S), A (G, Ci, S) (sequence n reads group
// n / (N / G): the ranks of the virtual mesh are folded into the sequences,
// each with its own channels' A), the state starting at h0 (N, Ci, S) or
// zero, y (N, T, Ci) and the final state written to h_out.  Everything is
// f32.  The TPU kernel's tiling (128-lane channel blocks, T padded to its
// chunk, Ci to 128) is not copied: ragged T and Ci are masked here.
//
// What bounds it on an H100: at the prefill shape (N 8, T 1280, Ci 3200,
// S 16) x and dt in and y out are 3 x 131 MB, B and C 1.3 MB each, h0/h_out
// 1.6 MB each: 398 MB, 0.119 ms at 3.35 TB/s.  The decays are N T Ci S =
// 524 M exponentials, each one MUFU.EX2 on the special-function units:
// 16 a clock on each of 132 SMs at 1.98 GHz (the CUDA programming guide's
// throughput table for compute capability 9.0), 4.18e12 a second, 0.125 ms.
// The ~6 f32 operations an element (dt A, the decayed state FMA, the drive,
// y's FMA) are 3.1 GFLOP, 0.047 ms at 67 TFLOP/s.  So the exponentials bound
// it, just above the bytes.  At decode (T = 1) it is launch-bound.
//
// Design:
//  * one thread per (sequence, channel), holding that channel's S state
//    values and its A row in registers, so y_t[c] needs no cross-thread
//    reduction; a CTA is kThreads channels of one sequence;
//  * the steps are staged in shared memory kC at a time, double buffered
//    with cp.async: each thread copies its own channel's x and dt (4-byte
//    copies, coalesced across the CTA; Ci need not be a multiple of 4), and
//    the CTA copies the chunk's B and C rows (16-byte copies), which every
//    thread then reads as broadcast 16-byte shared loads;
//  * any T >= 1 and any Ci: the last chunk and the last CTA of a sequence
//    are masked, nothing is padded;
//  * h0 and h_out may be the same buffer (the decode path updates its cache
//    in place with one launch a layer a step): each thread reads its own
//    state row before the loop and writes the same entries after it;
//  * the arithmetic of a step does not depend on where a chunk or a call
//    starts, so chained calls equal one call bitwise;
//  * expf (not the fast __expf): the decays of the path's dt reach far
//    below 1, where __expf's relative error grows.
// Shared memory: 2 x kC x (2 kThreads + 2 S) f32, 40 KB at S 16, static.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 64;        // channels a CTA
constexpr int kC = 32;              // steps a chunk

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int S>
struct Smem {
  float x[2][kC][kThreads];         // [buffer][step][channel]
  float dt[2][kC][kThreads];
  float b[2][kC * S];               // [buffer][step * S + state]
  float c[2][kC * S];
};

template <int S>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ a, const float* h0,
                float* __restrict__ y, float* h_out, int T, int Ci,
                int a_group) {
  static_assert(S % 4 == 0, "B/C rows are copied in 16-byte pieces");
  __shared__ __align__(16) Smem<S> sm;

  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const int n = blockIdx.y;
  const bool live = ch < Ci;
  const long long row0 = static_cast<long long>(n) * T;   // (n, t = 0)
  const int nc = (T + kC - 1) / kC;

  auto prefetch = [&](int ck, int buf) {
    const int t0 = ck * kC;
    const int ns = min(kC, T - t0);
    if (live) {
      for (int s = 0; s < ns; ++s) {
        const long long off = (row0 + t0 + s) * Ci + ch;
        cp_async4(&sm.x[buf][s][tid], x + off);
        cp_async4(&sm.dt[buf][s][tid], dt + off);
      }
    }
    const long long boff = (row0 + t0) * S;
    for (int p = tid; p < ns * S / 4; p += kThreads) {
      cp_async16(&sm.b[buf][4 * p], b + boff + 4 * p);
      cp_async16(&sm.c[buf][4 * p], c + boff + 4 * p);
    }
    cp_async_commit();
  };

  prefetch(0, 0);
  float h[S], A[S];
  const long long srow = (static_cast<long long>(n) * Ci + ch) * S;
  const long long arow =
      (static_cast<long long>(n / a_group) * Ci + ch) * S;
#pragma unroll
  for (int i = 0; i < S / 4; ++i) {
    const float4 aq = live ? reinterpret_cast<const float4*>(a + arow)[i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hq = live && h0 != nullptr
                          ? reinterpret_cast<const float4*>(h0 + srow)[i]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    A[4 * i] = aq.x; A[4 * i + 1] = aq.y; A[4 * i + 2] = aq.z;
    A[4 * i + 3] = aq.w;
    h[4 * i] = hq.x; h[4 * i + 1] = hq.y; h[4 * i + 2] = hq.z;
    h[4 * i + 3] = hq.w;
  }

  for (int ck = 0; ck < nc; ++ck) {
    const int buf = ck & 1;
    const int t0 = ck * kC;
    const int ns = min(kC, T - t0);
    if (ck + 1 < nc) {
      prefetch(ck + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float dtv = sm.dt[buf][s][tid];
      const float dx = dtv * sm.x[buf][s][tid];
      const float4* bq4 = reinterpret_cast<const float4*>(&sm.b[buf][s * S]);
      const float4* cq4 = reinterpret_cast<const float4*>(&sm.c[buf][s * S]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < S / 4; ++i) {
        const float4 bq = bq4[i], cq = cq4[i];
        const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& st = h[4 * i + j];
          st = fmaf(expf(A[4 * i + j] * dtv), st, dx * bb[j]);
          acc[j] = fmaf(st, cc[j], acc[j]);
        }
      }
      if (live) y[(row0 + t0 + s) * Ci + ch] = (acc[0] + acc[1]) +
                                               (acc[2] + acc[3]);
    }
    __syncthreads();   // buffer buf is refilled next
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      reinterpret_cast<float4*>(h_out + srow)[i] =
          make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

template <int S>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, void* y, void* h_out, int N, int T,
           int Ci, int G, void* stream) {
  dim3 grid((Ci + kThreads - 1) / kThreads, N);
  ssm_scan_kernel<S><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), T, Ci, N / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/dt (N, T, Ci), b/c (N, T, S), a (G, Ci, S), h0 (N, Ci, S) or null (zero
// state), y (N, T, Ci), h_out (N, Ci, S; may be h0).  All f32, contiguous,
// 16-byte aligned; S 8 or 16; G divides N.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* b,
                               const void* c, const void* a, const void* h0,
                               void* y, void* h_out, int N, int T, int Ci,
                               int S, int G, void* stream) {
  if (N <= 0 || T <= 0 || Ci <= 0 || G <= 0 || N % G || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 16)
    return launch<16>(x, dt, b, c, a, h0, y, h_out, N, T, Ci, G, stream);
  if (S == 8)
    return launch<8>(x, dt, b, c, a, h0, y, h_out, N, T, Ci, G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
