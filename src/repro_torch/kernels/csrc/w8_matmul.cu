// The rank-batched product x (R, M, K) @ W (R, K, N) with W held as int8
// plus bf16 scales, for Hopper (sm_90a): the decode step's block weights
// under weight_quant.
//
// Replaces no TPU kernel: the reference dequantizes a layer's weights in
// jnp (repro/parallel/quant.py::dequant_layer, :51) and runs its block
// einsums on the bf16 result.  On the card that order would read 1 byte a
// weight, write 2 and read 2 again, 2.5x the bf16 path's bytes, so the
// dequantization moves into the GEMM: each weight element is formed in
// registers as bf16(float(q) * float(s)), exactly the operand
// dequant_layer builds, and multiplied in f32 accumulate.  The scale of
// column n is s[n % P] (P = N for a plain leaf, hd for wq/wk/wv, whose
// reference scale runs along the head dim).
//
// What bounds it on an H100: the int8 weight stream.  At decode M (rows a
// rank) is 1-64, so a weight byte feeds at most 128 flop, under the
// tensor cores' ridge (~295 flop a byte in bf16): K * N bytes over 3.35
// TB/s.
//
// What the design does about it:
//  * the grid is (N / 32 column tiles, ks splits of K, R ranks), ks up to 8
//    (w8_splits), so even a 512-column leaf gives hundreds of CTAs; a CTA
//    copies its whole Kc x 32 int8 tile into shared memory with 16-byte
//    cp.async copies at once (rows padded to 48 bytes: the fragment reads
//    below hit distinct banks) and several CTAs share an SM;
//  * the four warps take the tile's k16 steps in turn.  A step's B
//    fragments (mma.sync m16n8k16, four n8 blocks) are built from the
//    shared int8 bytes: q to f32 by an integer add and a subtraction (no
//    I2F), times the column's scale, rounded to bf16 and packed; the A
//    fragments (x, bf16) come from global memory, each element read once
//    a CTA (x is small and stays in L2).  M is padded to 16-row tiles in
//    registers (MT = 1..4 tiles, rows past M are zeros);
//  * the warps' f32 sums meet in shared memory in warp order; with ks = 1
//    the CTA writes the output, else an f32 partial a split, and a second
//    launch sums the splits in order.  No atomics: two calls are bitwise
//    equal, and a CUDA graph can replay the pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;       // output columns of a CTA
constexpr int kRow = 48;        // shared bytes of a weight row (32 used)
constexpr int kMaxRows = 64;    // rows of x a launch (4 m16 tiles)
constexpr int kMaxSplits = 8;
constexpr int kMaxTile = 2048;  // rows of W a CTA

// K's splits: up to kMaxSplits, each a whole number of k16 steps and at
// least one step a warp, more when a CTA's tile would pass kMaxTile rows.
__host__ __device__ inline int w8_splits(int K) {
  int ks = kMaxSplits;
  while (K / ks > kMaxTile && ks < K / 16) ks *= 2;
  while (ks > 1 && (K % (16 * ks) || K / ks < 16 * kWarps)) ks /= 2;
  return ks;
}

__device__ __forceinline__ float i8_to_f32(int q) {
  return __int_as_float(0x4B000080 + q) - 8388736.f;
}

__device__ __forceinline__ unsigned ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// One CTA: columns n0 .. n0 + 31 of rank r over rows [k0, k0 + Kc) of W.
template <int MT>
__global__ void __launch_bounds__(kThreads)
w8_matmul_kernel(const bf16* __restrict__ x, const signed char* __restrict__ w,
                 const bf16* __restrict__ s, bf16* __restrict__ out,
                 float* __restrict__ ws, int M, int K, int N, int P,
                 int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kCols, split = blockIdx.y, r = blockIdx.z;
  const int ks = gridDim.y, Kc = K / ks, k0 = split * Kc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  signed char* wt = reinterpret_cast<signed char*>(smem);
  float* red = reinterpret_cast<float*>(smem + Kc * kRow);

  const signed char* wr = w + (static_cast<long long>(r) * K + k0) * N + n0;
  for (int i = threadIdx.x; i < 2 * Kc; i += kThreads) {
    const int row = i / 2, c = i % 2;
    tc::cp_async16(wt + row * kRow + c * 16,
                   wr + static_cast<long long>(row) * N + c * 16, 16);
  }
  tc::cp_async_commit();

  // this lane's B columns: nb * 8 + gq, and their scales
  float sc[4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
    sc[nb] = __bfloat162float(
        s[static_cast<long long>(r) * P + (n0 + nb * 8 + gq) % P]);
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;

  tc::cp_async_wait<0>();
  __syncthreads();
  const bf16* xr = x + static_cast<long long>(r) * M * K + k0;
  for (int j = warp; j < Kc / 16; j += kWarps) {
    const int kk = j * 16;
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = mt * 16 + gq, m1 = m0 + 8;
      const bf16* p0 = xr + static_cast<long long>(m0) * K + kk + 2 * tq;
      const bf16* p1 = p0 + 8LL * K;
      a[mt][0] = m0 < M ? ldg32(p0) : 0u;
      a[mt][1] = m1 < M ? ldg32(p1) : 0u;
      a[mt][2] = m0 < M ? ldg32(p0 + 8) : 0u;
      a[mt][3] = m1 < M ? ldg32(p1 + 8) : 0u;
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const signed char* b = wt + (kk + 2 * tq) * kRow + nb * 8 + gq;
      const unsigned b0 = tc::pack_bf16(i8_to_f32(b[0]) * sc[nb],
                                        i8_to_f32(b[kRow]) * sc[nb]);
      const unsigned b1 = tc::pack_bf16(i8_to_f32(b[8 * kRow]) * sc[nb],
                                        i8_to_f32(b[9 * kRow]) * sc[nb]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tc::mma_bf16(acc[mt][nb], a[mt], b0, b1);
    }
  }

  // the warps' sums, (warp, MT * 16, kCols), merged in warp order
  const int rows = MT * 16;
  float* rw = red + warp * rows * kCols;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rw[(mt * 16 + gq + 8 * (e >> 1)) * kCols + nb * 8 + 2 * tq +
           (e & 1)] = acc[mt][nb][e];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    float v = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) v += red[(w2 * rows + m) * kCols + c];
    const long long o = (static_cast<long long>(r) * M + m) * N + n0 + c;
    if (ks == 1)
      out[o] = __float2bfloat16(v);
    else
      ws[static_cast<long long>(split) * R * M * N + o] = v;
  }
}

// out[i] = bf16(the splits' partials summed in split order).
__global__ void __launch_bounds__(kThreads)
w8_matmul_combine(const float* __restrict__ ws, bf16* __restrict__ out,
                  long long n, int ks) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int j = 0; j < ks; ++j) v += ws[j * n + i];
  out[i] = __float2bfloat16(v);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, int* configured) {
  if (bytes <= *configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

template <int MT>
cudaError_t launch_mt(const bf16* x, const signed char* w, const bf16* s,
                      bf16* out, float* ws, int R, int M, int K, int N, int P,
                      int ks, cudaStream_t st) {
  auto kern = w8_matmul_kernel<MT>;
  static int configured = 48 * 1024;
  const int bytes = (K / ks) * kRow + kWarps * MT * 16 * kCols * 4;
  const cudaError_t e = allow_smem(kern, bytes, &configured);
  if (e != cudaSuccess) return e;
  kern<<<dim3(N / kCols, ks, R), kThreads, bytes, st>>>(x, w, s, out, ws, M,
                                                        K, N, P, R);
  return cudaGetLastError();
}

}  // namespace

// K's split count (kernels/w8_matmul/ops.py mirrors it for the workspace).
extern "C" int w8_matmul_splits(int K) { return w8_splits(K); }

// x (R, M, K) bf16; w (R, K, N) int8; s (R, P) bf16 with N % P == 0;
// out (R, M, N) bf16; ws f32 of w8_matmul_splits(K) * R * M * N elements
// when that is above 1 (else unused).  All contiguous, w 16-byte aligned;
// 1 <= M <= 64, K % 16 == 0, N % 32 == 0.
extern "C" int w8_matmul_launch(const void* x, const void* w, const void* s,
                                void* out, void* ws, int R, int M, int K,
                                int N, int P, void* stream) {
  if (R <= 0 || M <= 0 || M > kMaxRows || K <= 0 || K % 16 || N <= 0 ||
      N % kCols || P <= 0 || N % P)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = w8_splits(K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const signed char* wb = static_cast<const signed char*>(w);
  const bf16* sb = static_cast<const bf16*>(s);
  bf16* ob = static_cast<bf16*>(out);
  float* wsf = static_cast<float*>(ws);
  cudaError_t e;
  switch ((M + 15) / 16) {
    case 1: e = launch_mt<1>(xb, wb, sb, ob, wsf, R, M, K, N, P, ks, st); break;
    case 2: e = launch_mt<2>(xb, wb, sb, ob, wsf, R, M, K, N, P, ks, st); break;
    case 3: e = launch_mt<3>(xb, wb, sb, ob, wsf, R, M, K, N, P, ks, st); break;
    default: e = launch_mt<4>(xb, wb, sb, ob, wsf, R, M, K, N, P, ks, st);
  }
  if (e != cudaSuccess || ks == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(R) * M * N;
  w8_matmul_combine<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(wsf, ob, n, ks);
  return static_cast<int>(cudaGetLastError());
}
