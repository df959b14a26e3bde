// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py _ssm_kernel
// (ssm_scan_call): per sequence n, channel c and state s, over t = 0..T-1,
//     h[c,s] <- exp(A[c,s] dt_t[c]) h[c,s] + (dt_t[c] x_t[c]) B_t[s]
//     y_t[c]  = sum_s h[c,s] C_t[s]
// with x/dt (N, T, Ci), B/C (N, T, S) rows (possibly the two halves of one
// (N, T, 2S) tensor: the rows are read at a stride), A (G, Ci, S) (sequence
// n reads group n / (N / G): the ranks of the virtual mesh are folded into
// the sequences, each with its own channels' A), the state starting at h0
// (N, Ci, S) or zero, y (N, T, Ci) and the final state written to h_out.
// Everything is f32.  The TPU kernel's tiling (128-lane channel blocks, T
// padded to its chunk, Ci to 128) is not copied: ragged T and Ci are
// masked here.
//
// What bounds it on an H100: at the prefill shape (N 8, T 1280, Ci 3200,
// S 16) x and dt in and y out are 3 x 131 MB, B and C 1.3 MB each, h0/h_out
// 1.6 MB each: 398 MB, 0.119 ms at 3.35 TB/s.  The decays are N T Ci S =
// 524 M exponentials, each one MUFU.EX2 on the special-function units:
// 16 a clock on each of 132 SMs at 1.98 GHz (the CUDA programming guide's
// throughput table for compute capability 9.0), 4.18e12 a second, 0.125
// ms.  Issue comes close: each element also costs the decay's argument,
// the drive's product, the state's FMA and y's FMA, five instructions with
// the exponential, about 0.1 ms.  At decode (T = 1) the call is
// launch-bound.
//
// Design:
//  * each channel's S states are split across two lanes, S / 2 a lane, held
//    with their slice of the A row in registers and read as 16-byte pieces.
//    A CTA is one warp, 16 channels of one sequence: at hymba's widths (Ci
//    3200, or 400 a rank at tp=8) no CTA of a sequence is ragged, and 1600
//    CTAs run in one wave.  Four lanes a channel (twice the warps) measured
//    slower: each step's per-lane work (x, dt, the B/C pieces, dt x, the
//    partial's store) is shared by four states instead of eight;
//  * the exponential is exp2f of A pre-scaled by log2(e) once a thread.
//    Where every decay argument of a chunk is >= -126, exp2f is its one
//    MUFU.EX2 (ex2.approx.ftz), so the kernel checks that once a chunk (the
//    largest |a2| of a lane times the chunk's largest |dt|, exact under
//    rounding) and takes exp2f's subnormal path (a compare and two multiplies
//    an element) only in a chunk that needs it: the decays are exp2f's in
//    every case.  Its argument error is relative to the decay it scales, so
//    the state stays within the plain version's tolerance, the underflow
//    draw (dt up to 5, A down to -24) included;
//  * the general form stages the steps in shared memory kC at a time in a
//    ring of kRing chunks filled with cp.async (x and dt as 16-byte pieces
//    when Ci is a multiple of 4, else 4-byte ones; the B and C rows as
//    16-byte pieces at their row stride), one barrier a chunk.  Each step's
//    per-lane partials of y go to shared memory; once a chunk each lane sums
//    a channel's two and stores four channels' y of a step at once;
//  * a T = 1 form (the decode step, CTAs of 256 threads) loads x, dt, the
//    B/C rows, A and h0 straight to registers in one round trip and adds
//    the two partials after one shuffle; the launch picks it by T;
//  * both forms run one step through the same lane_step and add the two
//    lanes' partials in the same order, so a step's arithmetic does not
//    depend on T, on where a chunk or a call starts, or on the form: chained
//    calls and the in-place decode step equal one call bitwise;
//  * h0 and h_out may be the same buffer (the decode path updates its cache
//    in place with one launch a layer a step): each thread reads its own
//    state slice before the loop and writes the same entries after it.
// Shared memory: kRing x kC x (2 x 16 + 2 S) f32 plus kC x 32 partials,
// 15 KB at S 16, static.

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kLanes = 2;           // lanes a channel
constexpr int kThreads = 32;        // threads a CTA (one warp), general form
constexpr int kCh = kThreads / kLanes;          // channels a CTA
constexpr int kStepThreads = 256;   // threads a CTA, T = 1 form
constexpr int kC = 24;              // steps a chunk
constexpr int kRing = 2;            // chunks in the cp.async ring
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.44269504088896341f;

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

template <int P>
__device__ __forceinline__ void load_row(float (&out)[P], const float* p) {
#pragma unroll
  for (int i = 0; i < P / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = q.x; out[4 * i + 1] = q.y; out[4 * i + 2] = q.z;
    out[4 * i + 3] = q.w;
  }
}

// exp2f(x) is ex2.approx.ftz(x) wherever x >= -126: exp2f's one MUFU.EX2;
// only results below 2^-126 take its subnormal path.
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One step of one lane: the decays of its P states, their update and the
// lane's partial of y (its P products summed in state order).  kNormal:
// every decay argument of the step is known to be >= -126, so exp2f is its
// MUFU.EX2 alone; the decays are exp2f's either way.
template <bool kNormal, int P>
__device__ __forceinline__ float lane_step(float (&h)[P], const float (&a2)[P],
                                           float dtv, float xv,
                                           const float (&bq)[P],
                                           const float (&cq)[P]) {
  const float dx = dtv * xv;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float e = kNormal ? ex2_ftz(a2[i] * dtv) : exp2f(a2[i] * dtv);
    h[i] = fmaf(e, h[i], dx * bq[i]);
    part = i == 0 ? h[0] * cq[0] : fmaf(h[i], cq[i], part);
  }
  return part;
}

// Whether every a2[i] dt with |dt| <= dt_abs is >= -126: |a2 dt| <=
// a2_abs dt_abs exactly, and rounding keeps the order.
__device__ __forceinline__ bool normal_decays(float a2_abs, float dt_abs) {
  return a2_abs * dt_abs <= 126.f;
}

// A lane's slice of the state (from h0, or zero) and of A x log2(e); zeros
// in a lane past Ci.  Returns the slice's largest |a2|.
template <int P>
__device__ __forceinline__ float load_state(float (&h)[P], float (&a2)[P],
                                            const float* a, const float* h0,
                                            long long arow, long long srow,
                                            bool live) {
  float a2_abs = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) h[i] = a2[i] = 0.f;
  if (live) {
    load_row(a2, a + arow);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      a2[i] *= kLog2e;
      a2_abs = fmaxf(a2_abs, fabsf(a2[i]));
    }
    if (h0 != nullptr) load_row(h, h0 + srow);
  }
  return a2_abs;
}

template <int P>
__device__ __forceinline__ void store_state(float* h_out, const float (&h)[P]) {
#pragma unroll
  for (int i = 0; i < P / 4; ++i)
    reinterpret_cast<float4*>(h_out)[i] =
        make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
}

template <int S>
struct Smem {
  float x[kRing][kC][kCh];                   // [buffer][step][channel]
  float dt[kRing][kC][kCh];
  float b[kRing][kC][S];                     // [buffer][step][state]
  float c[kRing][kC][S];
  float part[kC][kThreads];                  // [step][lane]: y's partials
};                                           // of the chunk

// Four consecutive channels' y of one step: a 16-byte store where the row
// allows it, else the live ones one by one.
__device__ __forceinline__ void store_y4(float* y, float4 v, int live,
                                         bool vec) {
  if (vec && live >= 4) {
    *reinterpret_cast<float4*>(y) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < live) y[i] = e[i];
  }
}

// 13 CTAs an SM hold hymba's prefill (1600 CTAs) in one wave.
template <int S>
__global__ void __launch_bounds__(kThreads, 13)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ a, const float* h0,
                float* __restrict__ y, float* h_out, int T, int Ci,
                int bc_stride, int a_group) {
  constexpr int P = S / kLanes;
  static_assert(P % 4 == 0, "16-byte state and B/C pieces");
  __shared__ __align__(16) Smem<S> sm;

  const int tid = threadIdx.x;
  const int cl = tid / kLanes;               // the CTA's channel
  const int j = tid % kLanes;                // the lane's state slice
  const int ch0 = blockIdx.x * kCh;
  const int ch = ch0 + cl;
  const int n = blockIdx.y;
  const bool live = ch < Ci;
  const int nch = min(kCh, Ci - ch0);        // live channels of the CTA
  const bool vec = (Ci & 3) == 0;
  const long long row0 = static_cast<long long>(n) * T;   // (n, t = 0)
  const int nc = (T + kC - 1) / kC;

  auto prefetch = [&](int ck) {
    if (ck < nc) {
      const int buf = ck % kRing;
      const int t0 = ck * kC;
      const int ns = min(kC, T - t0);
      if (vec) {
        constexpr int Q = kCh / 4;           // 16-byte pieces of a row
        for (int p = tid; p < ns * Q; p += kThreads) {
          const int s = p / Q, q = 4 * (p % Q);
          if (q < nch) {
            const long long off = (row0 + t0 + s) * Ci + ch0 + q;
            cp_async16(&sm.x[buf][s][q], x + off);
            cp_async16(&sm.dt[buf][s][q], dt + off);
          }
        }
      } else {
        for (int p = tid; p < ns * kCh; p += kThreads) {
          const int s = p / kCh, q = p % kCh;
          if (q < nch) {
            const long long off = (row0 + t0 + s) * Ci + ch0 + q;
            cp_async4(&sm.x[buf][s][q], x + off);
            cp_async4(&sm.dt[buf][s][q], dt + off);
          }
        }
      }
      constexpr int SQ = S / 4;
      for (int p = tid; p < ns * SQ; p += kThreads) {
        const int s = p / SQ, q = 4 * (p % SQ);
        const long long off = (row0 + t0 + s) * bc_stride + q;
        cp_async16(&sm.b[buf][s][q], b + off);
        cp_async16(&sm.c[buf][s][q], c + off);
      }
    }
    cp_async_commit();      // an empty group past the last chunk: the wait
  };                        // below counts groups, not chunks

#pragma unroll
  for (int ck = 0; ck < kRing - 1; ++ck) prefetch(ck);
  float h[P], a2[P];
  const float a2_abs = load_state(
      h, a2, a, h0, (static_cast<long long>(n / a_group) * Ci + ch) * S + j * P,
      (static_cast<long long>(n) * Ci + ch) * S + j * P, live);

  for (int ck = 0; ck < nc; ++ck) {
    cp_async_wait<kRing - 2>();   // chunk ck has landed for this thread,
    __syncthreads();              // for all; chunk ck - 1's buffers are free
    prefetch(ck + kRing - 1);
    const int buf = ck % kRing;
    const int t0 = ck * kC;
    const int ns = min(kC, T - t0);
    // exp2f takes no subnormal path anywhere in this chunk of this CTA
    float dt_abs = 0.f;
    for (int s = 0; s < ns; ++s)
      dt_abs = fmaxf(dt_abs, fabsf(sm.dt[buf][s][cl]));
    const bool normal =
        __all_sync(kFull, !live || normal_decays(a2_abs, dt_abs));
    auto steps = [&](auto kNormal) {
      auto step = [&](int s) {
        float bq[P], cq[P];
        load_row(bq, &sm.b[buf][s][j * P]);
        load_row(cq, &sm.c[buf][s][j * P]);
        sm.part[s][tid] = lane_step<decltype(kNormal)::value>(
            h, a2, sm.dt[buf][s][cl], sm.x[buf][s][cl], bq, cq);
      };
      if (ns == kC) {
#pragma unroll
        for (int s = 0; s < kC; ++s) step(s);
      } else {
        for (int s = 0; s < ns; ++s) step(s);
      }
    };
    if (normal)
      steps(std::true_type());
    else
      steps(std::false_type());
    __syncwarp();   // the chunk's partials are in
    constexpr int kQ = kCh / 4;   // channel quads a CTA
    for (int p = tid; p < ns * kQ; p += kThreads) {
      const int s = p / kQ;
      const int c4 = 4 * (p % kQ);
      float q[4 * kLanes];   // the quad's channels' lanes' partials, in a row
      load_row(q, &sm.part[s][c4 * kLanes]);
      store_y4(y + (row0 + t0 + s) * Ci + ch0 + c4,
               make_float4(q[0] + q[1], q[2] + q[3], q[4] + q[5],
                           q[6] + q[7]),
               nch - c4, vec);
    }
  }

  if (live)
    store_state(h_out + (static_cast<long long>(n) * Ci + ch) * S + j * P, h);
}

// T = 1: every operand straight to registers, one round trip; the two
// lanes' partials added in lane 0 of the channel, in the general form's
// order.
template <int S>
__global__ void __launch_bounds__(kStepThreads)
ssm_scan_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ a, const float* h0,
                float* __restrict__ y, float* h_out, int Ci, int bc_stride,
                int a_group) {
  constexpr int P = S / kLanes;
  constexpr int kStepCh = kStepThreads / kLanes;
  const int tid = threadIdx.x;
  const int j = tid % kLanes;
  const int ch = blockIdx.x * kStepCh + tid / kLanes;
  const int n = blockIdx.y;
  const bool live = ch < Ci;
  const long long xo = static_cast<long long>(n) * Ci + ch;
  const float xv = live ? x[xo] : 0.f;
  const float dtv = live ? dt[xo] : 0.f;
  float bq[P], cq[P], h[P], a2[P];
  load_row(bq, b + static_cast<long long>(n) * bc_stride + j * P);
  load_row(cq, c + static_cast<long long>(n) * bc_stride + j * P);
  const float a2_abs = load_state(
      h, a2, a, h0, (static_cast<long long>(n / a_group) * Ci + ch) * S + j * P,
      xo * S + j * P, live);
  const float part = normal_decays(a2_abs, fabsf(dtv))
                         ? lane_step<true>(h, a2, dtv, xv, bq, cq)
                         : lane_step<false>(h, a2, dtv, xv, bq, cq);
  const float other = __shfl_xor_sync(kFull, part, 1);
  if (live) {
    if (j == 0) y[xo] = part + other;
    store_state(h_out + xo * S + j * P, h);
  }
}

template <int S>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, void* y, void* h_out, int N, int T,
           int Ci, int G, int bc_stride, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h0);
  constexpr int kStepCh = kStepThreads / kLanes;
  if (T == 1)
    ssm_scan_step_kernel<S><<<dim3((Ci + kStepCh - 1) / kStepCh, N), kStepThreads,
                         0, st>>>(xf, df, bf, cf, af, hf,
                                  static_cast<float*>(y),
                                  static_cast<float*>(h_out), Ci, bc_stride,
                                  N / G);
  else
    ssm_scan_kernel<S><<<dim3((Ci + kCh - 1) / kCh, N), kThreads, 0, st>>>(
        xf, df, bf, cf, af, hf, static_cast<float*>(y),
        static_cast<float*>(h_out), T, Ci, bc_stride, N / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/dt (N, T, Ci) contiguous; b/c (N, T, S) rows of S contiguous f32,
// consecutive (n, t) rows bc_stride floats apart (S for contiguous b and
// c, 2S for the halves of one (N, T, 2S) tensor); a (G, Ci, S); h0 (N, Ci,
// S) or null (zero state); y (N, T, Ci); h_out (N, Ci, S; may be h0).  All
// f32 and 16-byte aligned, bc_stride a multiple of 4; S 8 or 16; G divides
// N.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* b,
                               const void* c, const void* a, const void* h0,
                               void* y, void* h_out, int N, int T, int Ci,
                               int S, int G, int bc_stride, void* stream) {
  if (N <= 0 || T <= 0 || Ci <= 0 || G <= 0 || N % G || N > 65535 ||
      bc_stride < 0 || bc_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 16)
    return launch<16>(x, dt, b, c, a, h0, y, h_out, N, T, Ci, G, bc_stride,
                      stream);
  if (S == 8)
    return launch<8>(x, dt, b, c, a, h0, y, h_out, N, T, Ci, G, bc_stride,
                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
