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
// 0.105 ms at 3.35 TB/s.  A step of a head costs at least 3 hd^2 FP32
// instructions (the k v product, the decayed state's FMA, y's FMA): 3.2 G
// at one warp instruction a clock on each of the 528 schedulers, 0.096 ms,
// and every shared load, shuffle or barrier takes an issue slot from them
// (no tensor core helps a rank-one update).  So bytes bound it, with issue
// close behind.  At decode (T = 1) the state is the traffic: 16.8 MB in and
// out, 0.005 ms.
//
// Design:
//  * a register tile of S per thread: thread (kg, vg) holds key rows
//    8 kg .. 8 kg + 7 of value columns 4 vg .. 4 vg + 3 (32 floats, read and
//    written as float4 rows), so a CTA (one head of one sequence) is
//    hd^2 / 32 threads, 128 at hd 64, and each r, k or decay value a thread
//    loads from shared memory feeds its four columns;
//  * a step: acc[c] = sum over the tile's 8 keys of r S (in key order), then
//    S = fma(w, S, k v); the 4 partials go to shared memory, and once a
//    chunk each output element sums its hd / 8 key groups' partials in a
//    fixed pairwise tree, adding v[c] x bonus, the bonus being the same tree
//    over the groups' sums of r u k;
//  * the steps are staged in shared memory kC at a time in a ring of kRing
//    chunks filled with cp.async; once a chunk has landed each warp
//    exponentiates the decays of its own key rows in place and sums r u k
//    over each of its key groups (no barrier: only the warp reads them until
//    the chunk's one other barrier, before the y sums);
//  * a T = 1 form (the decode step) loads its operands and its state tile
//    straight to registers as float4 rows in one round trip, exponentiates
//    its own 8 decays and sums its group's bonus itself; the launch picks it
//    by T;
//  * both forms run a step through the same tile_step, group_bonus and
//    y_sum, so a step's arithmetic does not depend on T, on where a chunk or
//    a call starts, or on the form: chained calls and the in-place decode
//    step equal one call bitwise;
//  * s0 and s_out may be the same buffer (the decode path updates its cache
//    in place): each thread reads its own tile of s0 before the loop and
//    writes the same entries after it.
// Shared memory: kRing x 4 x kC x hd f32 ring (24 KB at hd 64) plus kC x hd
// x hd / 8 partials (16 KB), static.

#include "attention_common.cuh"

namespace {

constexpr int kC = 8;               // steps a chunk
constexpr int kRing = 3;            // chunks in the cp.async ring
constexpr int kKR = 8;              // key rows of a thread's tile
constexpr int kVC = 4;              // value columns of a thread's tile

template <int HD>
struct Plan {
  static constexpr int kKG = HD / kKR;            // key groups
  static constexpr int kVG = HD / kVC;            // value groups
  static constexpr int kThreads = kKG * kVG;      // hd 64: 128; hd 32: 32
  static constexpr int kGW = 32 / kVG;            // key groups a warp
  static_assert(kThreads % 32 == 0 && 32 % kVG == 0, "whole warps");
};

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

// One step of a thread's tile: y's partials over its key rows (taken
// before the update) and the decayed state plus k v.
__device__ __forceinline__ float4 tile_step(float (&S)[kKR][kVC],
                                            const float (&r)[kKR],
                                            const float (&k)[kKR],
                                            const float (&w)[kKR],
                                            const float (&v)[kVC]) {
  float acc[kVC];
#pragma unroll
  for (int i = 0; i < kKR; ++i) {
#pragma unroll
    for (int c = 0; c < kVC; ++c) {
      acc[c] = i == 0 ? r[0] * S[0][c] : fmaf(r[i], S[i][c], acc[c]);
      S[i][c] = fmaf(w[i], S[i][c], k[i] * v[c]);
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// sum over one key group's 8 keys of r u k, in key order
__device__ __forceinline__ float group_bonus(const float (&r)[kKR],
                                             const float (&u)[kKR],
                                             const float (&k)[kKR]) {
  float b = (r[0] * u[0]) * k[0];
#pragma unroll
  for (int i = 1; i < kKR; ++i) b = fmaf(r[i] * u[i], k[i], b);
  return b;
}

// y of 4 value columns: the key groups' partials (rows `stride` floats
// apart) and bonuses summed in a fixed pairwise tree, then v x bonus added.
template <int KG>
__device__ __forceinline__ float4 y_sum(const float* part, int stride,
                                        const float* bonus, float4 v) {
  float4 p[KG];
  float b[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    p[g] = *reinterpret_cast<const float4*>(part + g * stride);
    b[g] = bonus[g];
  }
#pragma unroll
  for (int w = 1; w < KG; w *= 2) {
#pragma unroll
    for (int g = 0; g + w < KG; g += 2 * w) {
      p[g].x += p[g + w].x; p[g].y += p[g + w].y;
      p[g].z += p[g + w].z; p[g].w += p[g + w].w;
      b[g] += b[g + w];
    }
  }
  return make_float4(fmaf(v.x, b[0], p[0].x), fmaf(v.y, b[0], p[0].y),
                     fmaf(v.z, b[0], p[0].z), fmaf(v.w, b[0], p[0].w));
}

template <int HD>
struct Smem {
  float buf[kRing][4][kC][HD];          // [buffer][r, k, v, decay][step][ch]
  float part[kC][Plan<HD>::kKG][HD];    // y's partials of each key group
  float bonus[kC][Plan<HD>::kKG];       // r u k summed over each key group
  float u[HD];
};

// At most 128 registers a thread at hd 64: four CTAs an SM hold all 512 of
// the prefill's (head, sequence) pairs in one wave.
template <int HD>
__global__ void __launch_bounds__(Plan<HD>::kThreads, 4)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* s_out, int T, int H,
                  int u_group) {
  using P = Plan<HD>;
  constexpr int kQ = HD / 4;        // 16-byte pieces of one step's row
  constexpr int kWK = P::kGW * kKR; // keys of a warp
  __shared__ __align__(16) Smem<HD> sm;

  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int kg = tid / P::kVG;
  const int vg = tid % P::kVG;
  const int lane = tid % 32;
  const int wk0 = (tid / 32) * kWK;     // the warp's first key row
  const long long row = static_cast<long long>(H) * HD;   // one step
  const long long base = (static_cast<long long>(n) * T * H + h) * HD;
  const int nc = (T + kC - 1) / kC;

  const float* const src[4] = {r, k, v, logw};
  auto prefetch = [&](int ck) {
    if (ck < nc) {
      const int b = ck % kRing;
      const int t0 = ck * kC;
      const int ns = min(kC, T - t0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        for (int p = tid; p < ns * kQ; p += P::kThreads) {
          const int s = p / kQ, q = 4 * (p % kQ);
          cp_async16(&sm.buf[b][a][s][q], src[a] + base + (t0 + s) * row + q);
        }
      }
    }
    cp_async_commit();      // an empty group past the last chunk: the wait
  };                        // below counts groups, not chunks

#pragma unroll
  for (int ck = 0; ck < kRing - 1; ++ck) prefetch(ck);
  for (int i = tid; i < HD; i += P::kThreads)
    sm.u[i] = u[(static_cast<long long>(n / u_group) * H + h) * HD + i];
  float S[kKR][kVC];
  const long long sbase = ((static_cast<long long>(n) * H + h) * HD +
                           kKR * kg) * HD + kVC * vg;
#pragma unroll
  for (int i = 0; i < kKR; ++i) {
    if (s0 != nullptr) {
      load_row(S[i], s0 + sbase + i * HD);
    } else {
#pragma unroll
      for (int c = 0; c < kVC; ++c) S[i][c] = 0.f;
    }
  }

  for (int ck = 0; ck < nc; ++ck) {
    cp_async_wait<kRing - 2>();   // chunk ck has landed for this thread,
    __syncthreads();              // for all; chunk ck - 1 is consumed
    prefetch(ck + kRing - 1);
    const int b = ck % kRing;
    const int t0 = ck * kC;
    const int ns = min(kC, T - t0);
    // the warp's own key rows: decays exponentiated in place, then each of
    // its key groups' bonus sums
    for (int p = lane; p < kC * kWK / 4; p += 32) {
      const int s = p / (kWK / 4);
      float* w = &sm.buf[b][3][s][wk0 + 4 * (p % (kWK / 4))];
      if (s < ns) {
        const float4 lw = *reinterpret_cast<const float4*>(w);
        *reinterpret_cast<float4*>(w) =
            make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w));
      }
    }
    for (int p = lane; p < kC * P::kGW; p += 32) {
      const int s = p / P::kGW;
      const int g = wk0 / kKR + p % P::kGW;
      if (s < ns) {
        float rr[kKR], uu[kKR], kk[kKR];
        load_row(rr, &sm.buf[b][0][s][kKR * g]);
        load_row(uu, &sm.u[kKR * g]);
        load_row(kk, &sm.buf[b][1][s][kKR * g]);
        sm.bonus[s][g] = group_bonus(rr, uu, kk);
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      if (s == ns) break;
      float rr[kKR], kk[kKR], ww[kKR], vv[kVC];
      load_row(rr, &sm.buf[b][0][s][kKR * kg]);
      load_row(kk, &sm.buf[b][1][s][kKR * kg]);
      load_row(ww, &sm.buf[b][3][s][kKR * kg]);
      load_row(vv, &sm.buf[b][2][s][kVC * vg]);
      *reinterpret_cast<float4*>(&sm.part[s][kg][kVC * vg]) =
          tile_step(S, rr, kk, ww, vv);
    }
    __syncthreads();   // every key group's partials are in
    for (int p = tid; p < ns * P::kVG; p += P::kThreads) {
      const int s = p / P::kVG;
      const int q = kVC * (p % P::kVG);
      *reinterpret_cast<float4*>(y + base + (t0 + s) * row + q) =
          y_sum<P::kKG>(&sm.part[s][0][q], HD, sm.bonus[s],
                        *reinterpret_cast<const float4*>(&sm.buf[b][2][s][q]));
    }
  }

#pragma unroll
  for (int i = 0; i < kKR; ++i)
    *reinterpret_cast<float4*>(s_out + sbase + i * HD) =
        make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
}

// T = 1: operands and the state tile straight to registers, one round trip.
template <int HD>
__global__ void __launch_bounds__(Plan<HD>::kThreads)
rwkv6_scan_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* s_out, int H, int u_group) {
  using P = Plan<HD>;
  __shared__ __align__(16) float part[P::kKG][HD];
  __shared__ float bonus[P::kKG];

  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int kg = tid / P::kVG;
  const int vg = tid % P::kVG;
  const long long base = (static_cast<long long>(n) * H + h) * HD;
  const long long sbase = (base + kKR * kg) * HD + kVC * vg;
  float rr[kKR], kk[kKR], ww[kKR], vv[kVC], S[kKR][kVC];
  load_row(rr, r + base + kKR * kg);
  load_row(kk, k + base + kKR * kg);
  load_row(ww, logw + base + kKR * kg);
  load_row(vv, v + base + kVC * vg);
#pragma unroll
  for (int i = 0; i < kKR; ++i) {
    if (s0 != nullptr) {
      load_row(S[i], s0 + sbase + i * HD);
    } else {
#pragma unroll
      for (int c = 0; c < kVC; ++c) S[i][c] = 0.f;
    }
  }
  if (vg == 0) {
    float uu[kKR];
    load_row(uu, u + (static_cast<long long>(n / u_group) * H + h) * HD +
                     kKR * kg);
    bonus[kg] = group_bonus(rr, uu, kk);
  }
#pragma unroll
  for (int i = 0; i < kKR; ++i) ww[i] = expf(ww[i]);
  *reinterpret_cast<float4*>(&part[kg][kVC * vg]) =
      tile_step(S, rr, kk, ww, vv);
#pragma unroll
  for (int i = 0; i < kKR; ++i)
    *reinterpret_cast<float4*>(s_out + sbase + i * HD) =
        make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
  __syncthreads();
  if (kg == 0)
    *reinterpret_cast<float4*>(y + base + kVC * vg) = y_sum<P::kKG>(
        &part[0][kVC * vg], HD, bonus,
        make_float4(vv[0], vv[1], vv[2], vv[3]));
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* y, void* s_out, int N, int T,
           int H, int G, void* stream) {
  const dim3 grid(H, N);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  if (T == 1)
    rwkv6_scan_step_kernel<HD><<<grid, Plan<HD>::kThreads, 0, st>>>(
        rf, kf, vf, wf, uf, sf, static_cast<float*>(y),
        static_cast<float*>(s_out), H, N / G);
  else
    rwkv6_scan_kernel<HD><<<grid, Plan<HD>::kThreads, 0, st>>>(
        rf, kf, vf, wf, uf, sf, static_cast<float*>(y),
        static_cast<float*>(s_out), T, H, N / G);
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
