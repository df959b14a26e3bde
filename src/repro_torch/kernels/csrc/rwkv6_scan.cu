// RWKV6 time-mix recurrence ("Finch": data-dependent per-channel decay), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// _rwkv_kernel (rwkv6_scan_call): per sequence n and head h, over t = 0..T-1,
//     y_t = r_t . (S + diag(u) k_t v_t^T)
//     S   <- diag(exp(logw_t)) S + k_t v_t^T
// with r/k/v/logw (N, T, H, hd), the bonus u (G, H, hd) (sequence n reads
// group n / (N / G): the ranks of the virtual mesh are folded into the
// sequences, each with its own heads' u), the state S (hd x hd, key dim x
// value dim) starting at s0 (N, H, hd, hd) or zero, y (N, T, H, hd) and the
// final S written to s_out.  Everything is f32.  This is the step-exact
// recurrence of repro/models/rwkv.py::rwkv_scan_ref, not the TPU kernel's
// chunked form: that form scales k by exp(min(-L, 60)) and is wrong once a
// chunk's decay sum passes -60; here every step multiplies by its own decay
// (<= 1) and nothing is clamped.
//
// What bounds it on an H100: at the prefill shape (N 8, T 512, H 64, hd 64)
// r/k/v/logw in and y out are 5 x 67 MB, s0 and s_out 8.4 MB each: 352 MB,
// 0.105 ms at 3.35 TB/s.  The ~5 hd^2 operations a step and head (the
// k v^T outer product, the decayed state and its sum, y's dot) come to
// 5.4 GFLOP, 0.080 ms at the 67 TFLOP/s of the CUDA cores (no tensor core
// helps a rank-one update).  So bytes bound it, but only just: the kernel
// has to stream its inputs while keeping the FMA pipes busy.  At decode
// (T = 1) the state is the traffic: 16.8 MB in and out, 0.005 ms.
//
// Design:
//  * one CTA per (head, sequence), hd threads; thread v owns column v of S
//    in registers (hd floats), so a step needs no cross-thread reduction:
//    y[v] = sum_k r[k] S[k][v] + v[v] * (sum_k r[k] u[k] k[k]) and
//    S[k][v] = exp(logw[k]) S[k][v] + k[k] v[v];
//  * the steps are staged in shared memory kC = 16 at a time, double
//    buffered with cp.async: while one chunk is consumed the next is in
//    flight, so the step loop never waits on device memory.  Once a chunk
//    has landed its decays are exponentiated in place (each thread its own
//    channel) and the bonus scalar sum_k r u k of each of its steps is
//    summed by hd / kC threads and a shuffle, then the step loop reads
//    r, k and exp(logw) as broadcast 16-byte shared loads;
//  * any T >= 1: the last chunk is masked, nothing is padded;
//  * s0 and s_out may be the same buffer (the decode path updates its
//    cache in place): each thread reads its own column of s0 before the
//    loop and writes the same entries after it.
// Shared memory: 2 x 4 x kC x hd f32 (32 KB at hd 64) plus u and the
// bonuses, static.

#include "attention_common.cuh"

namespace {

constexpr int kC = 16;              // steps a chunk
constexpr unsigned kFull = 0xffffffffu;

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

template <int HD>
struct Smem {
  float buf[2][4][kC][HD];           // [buffer][r, k, v, logw][step][chan]
  float u[HD];
  float bonus[kC];
};

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* s_out, int T, int H,
                  int u_group) {
  static_assert(HD % kC == 0 && HD <= 64, "hd / kC threads sum a bonus");
  constexpr int kQ = HD / 4;        // 16-byte pieces of one step's row
  constexpr int kP = HD / kC;       // threads summing one step's bonus
  __shared__ __align__(16) Smem<HD> sm;

  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(H) * HD;   // one step
  const long long base = (static_cast<long long>(n) * T * H + h) * HD;
  const int nc = (T + kC - 1) / kC;

  auto prefetch = [&](int c, int b) {
    const int t0 = c * kC;
    const int ns = min(kC, T - t0);
#pragma unroll
    for (int p = tid; p < 4 * kC * kQ; p += HD) {
      const int a = p / (kC * kQ);
      const int s = (p / kQ) % kC;
      const int q = p % kQ;
      const float* g = a == 0 ? r : a == 1 ? k : a == 2 ? v : logw;
      if (s < ns)
        cp_async16(&sm.buf[b][a][s][q * 4],
                   g + base + (t0 + s) * row + q * 4);
    }
    cp_async_commit();
  };

  prefetch(0, 0);
  sm.u[tid] = u[(static_cast<long long>(n / u_group) * H + h) * HD + tid];
  float S[HD];
  const long long sbase = (static_cast<long long>(n) * H + h) * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i)
    S[i] = s0 != nullptr ? s0[sbase + static_cast<long long>(i) * HD + tid]
                         : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int b = c & 1;
    const int t0 = c * kC;
    const int ns = min(kC, T - t0);
    if (c + 1 < nc) {
      prefetch(c + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // decays exponentiated in place, each thread its own channel; the
    // bonus scalar of each step summed by kP adjacent lanes
    for (int s = 0; s < ns; ++s)
      sm.buf[b][3][s][tid] = expf(sm.buf[b][3][s][tid]);
    {
      const int s = tid / kP;
      const int k0 = (tid % kP) * kC;
      float part = 0.f;
      if (s < ns) {
#pragma unroll
        for (int i = 0; i < kC; ++i)
          part = fmaf(sm.buf[b][0][s][k0 + i] * sm.u[k0 + i],
                      sm.buf[b][1][s][k0 + i], part);
      }
#pragma unroll
      for (int o = kP / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o);
      if (tid % kP == 0 && s < ns) sm.bonus[s] = part;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float4* rs = reinterpret_cast<const float4*>(sm.buf[b][0][s]);
      const float4* ks = reinterpret_cast<const float4*>(sm.buf[b][1][s]);
      const float4* ws = reinterpret_cast<const float4*>(sm.buf[b][3][s]);
      const float vv = sm.buf[b][2][s][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 rq = rs[i], kq = ks[i], wq = ws[i];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& st = S[4 * i + j];
          acc[j] = fmaf(rr[j], st, acc[j]);
          st = fmaf(ww[j], st, kk[j] * vv);
        }
      }
      y[base + (t0 + s) * row + tid] =
          fmaf(vv, sm.bonus[s], (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();   // buffer b and the bonuses are refilled next
  }

#pragma unroll
  for (int i = 0; i < HD; ++i)
    s_out[sbase + static_cast<long long>(i) * HD + tid] = S[i];
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* y, void* s_out, int N, int T,
           int H, int G, void* stream) {
  dim3 grid(H, N);
  rwkv6_scan_kernel<HD><<<grid, HD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T, H, N / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v/logw (N, T, H, hd), u (G, H, hd), s0 (N, H, hd, hd) or null (zero
// state), y (N, T, H, hd), s_out (N, H, hd, hd; may be s0).  All f32,
// contiguous, 16-byte aligned; hd 32 or 64; G divides N.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* s0, void* y, void* s_out, int N,
                                 int T, int H, int hd, int G, void* stream) {
  if (N <= 0 || T <= 0 || H <= 0 || G <= 0 || N % G || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch<64>(r, k, v, logw, u, s0, y, s_out, N, T, H, G, stream);
  if (hd == 32)
    return launch<32>(r, k, v, logw, u, s0, y, s_out, N, T, H, G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
