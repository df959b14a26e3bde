// Group-quantized pack and unpack of the quantized collectives' payloads,
// for Hopper (sm_90a): the wire format of ar_quant = int8 | int4 (and of
// the legacy compress_slow / quant_ag knobs at int8, group 128).
//
// Replaces the TPU kernels src/repro/kernels/rd_allreduce/quant_kernel.py
// _quantize_kernel (quantize_pack_pallas) and _dequant_kernel
// (unpack_dequant_pallas), which are pinned bit for bit to the jnp
// reference kernels/rd_allreduce/quant.py.  These kernels are pinned the
// same way to their plain version, quant_pack/ref.py.
//
// What they compute.  x is n contiguous elements (rows of D, D a multiple
// of the group, so a group never crosses a row), f32 or bf16.  Pack: for
// every group of `group` consecutive elements (a power of two, 1..128)
//   scale = max(absmax / qmax, 1e-30)          (f32, IEEE division)
//   q     = clip(rint(x / scale), -qmax, qmax) (f32 scale, half to even)
// then stores q as int8 (bits 8, qmax 127) or as nibble pairs (bits 4,
// qmax 7): byte i = (q[2i] & 0xF) | (q[2i+1] & 0xF) << 4, and the scale
// rounded to bf16.  Unpack: sign-extended q times the bf16 scale, f32.
//
// Numerics kept bitwise: rint / __float2int_rn round half to even as
// jnp.round; both divisions are IEEE divisions (no fast math, no
// reciprocal); q uses the f32 scale, only the stored scale is bf16.
// fmaxf would drop a NaN where jnp.max keeps it, so the absmax and the
// eps clamp go through nan_max: a NaN or Inf makes its own group's scale
// non-finite and unpack poisons exactly that group.
//
// Layout of the work.  Pack: one warp per tile of max(64, group)
// elements, each lane owning 2 (or, at group 128, 4) adjacent elements,
// so an int4 pair never straddles lanes; a group's absmax is reduced
// across its group / (elements a lane) lanes with xor shuffles (at group
// 1 every element is its own group).  Unpack: one thread per payload
// byte.  Grid-stride loops over both.
//
// What bounds them on an H100: bytes (a few operations an element).  Pack
// reads 4 (or 2) bytes an element and writes 1 (or 1/2) plus 2/group;
// unpack the reverse with a 4-byte f32 output.  Loads and stores are
// scalar (a lane's 8 bytes are adjacent, a warp's 256 contiguous), which
// a later PR can widen to 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-30f;

// max that keeps a NaN from either side, as jnp.max / jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int QMAX>
__device__ __forceinline__ int quantize(float v, float scale) {
  // NaN converts to 0 here; its group's payload is unspecified anyway
  int q = __float2int_rn(v / scale);
  return q > QMAX ? QMAX : (q < -QMAX ? -QMAX : q);
}

template <int BITS, int GROUP, typename T>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ packed,
                     __nv_bfloat16* __restrict__ scales, long long n) {
  constexpr int kTile = GROUP > 64 ? GROUP : 64;
  constexpr int kPer = kTile / 32;                  // elements a lane
  constexpr int kLanes = GROUP >= kPer ? GROUP / kPer : 1;  // lanes a group
  constexpr int kQmax = BITS == 8 ? 127 : 7;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const long long n_tiles = (n + kTile - 1) / kTile;
  for (long long t = warp; t < n_tiles; t += n_warps) {
    const long long base = t * kTile + lane * kPer;
    float v[kPer], s[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      v[e] = base + e < n ? to_float(x[base + e]) : 0.f;
    if (GROUP == 1) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        s[e] = nan_max(fabsf(v[e]) / static_cast<float>(kQmax), kEps);
    } else {
      float a = fabsf(v[0]);
#pragma unroll
      for (int e = 1; e < kPer; ++e) a = nan_max(a, fabsf(v[e]));
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
      const float sc = nan_max(a / static_cast<float>(kQmax), kEps);
#pragma unroll
      for (int e = 0; e < kPer; ++e) s[e] = sc;
    }
    int q[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) q[e] = quantize<kQmax>(v[e], s[e]);
    if (BITS == 8) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (base + e < n) packed[base + e] = static_cast<int8_t>(q[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; e += 2)
        if (base + e < n)
          packed[(base + e) >> 1] = static_cast<int8_t>(
              (q[e] & 0xF) | ((q[e + 1] & 0xF) << 4));
    }
    if (GROUP == 1) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (base + e < n) scales[base + e] = __float2bfloat16_rn(s[e]);
    } else if (lane % kLanes == 0 && base < n) {
      scales[base / GROUP] = __float2bfloat16_rn(s[0]);
    }
  }
}

// n_bytes payload bytes -> n_bytes (bits 8) or 2 n_bytes (bits 4) f32
template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_kernel(const int8_t* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ scales,
                      float* __restrict__ out, long long n_bytes,
                      int group_shift) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n_bytes; i += stride) {
    const int b = packed[i];
    if (BITS == 8) {
      out[i] = static_cast<float>(b) *
               __bfloat162float(scales[i >> group_shift]);
    } else {
      int lo = b & 0xF, hi = (b >> 4) & 0xF;
      lo = lo > 7 ? lo - 16 : lo;
      hi = hi > 7 ? hi - 16 : hi;
      const long long j = 2 * i;
      out[j] = static_cast<float>(lo) *
               __bfloat162float(scales[j >> group_shift]);
      out[j + 1] = static_cast<float>(hi) *
                   __bfloat162float(scales[(j + 1) >> group_shift]);
    }
  }
}

int grid_for(long long work, int per_block) {
  long long g = (work + per_block - 1) / per_block;
  const long long cap = 132LL * 16;               // a few waves of CTAs
  return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

template <int BITS, int GROUP>
int launch_pack(const void* x, void* packed, void* scales, long long n,
                int is_bf16, void* stream) {
  constexpr int kTile = GROUP > 64 ? GROUP : 64;
  const int grid = grid_for((n + kTile - 1) / kTile, kThreads / 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<int8_t*>(packed);
  auto* sc = static_cast<__nv_bfloat16*>(scales);
  if (is_bf16)
    quantize_pack_kernel<BITS, GROUP, __nv_bfloat16>
        <<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), p, sc, n);
  else
    quantize_pack_kernel<BITS, GROUP, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), p, sc, n);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_pack_group(const void* x, void* packed, void* scales, long long n,
                      int group, int is_bf16, void* stream) {
  switch (group) {
    case 1: return launch_pack<BITS, 1>(x, packed, scales, n, is_bf16, stream);
    case 2: return launch_pack<BITS, 2>(x, packed, scales, n, is_bf16, stream);
    case 4: return launch_pack<BITS, 4>(x, packed, scales, n, is_bf16, stream);
    case 8: return launch_pack<BITS, 8>(x, packed, scales, n, is_bf16, stream);
    case 16:
      return launch_pack<BITS, 16>(x, packed, scales, n, is_bf16, stream);
    case 32:
      return launch_pack<BITS, 32>(x, packed, scales, n, is_bf16, stream);
    case 64:
      return launch_pack<BITS, 64>(x, packed, scales, n, is_bf16, stream);
    case 128:
      return launch_pack<BITS, 128>(x, packed, scales, n, is_bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n contiguous f32 (bf16 when is_bf16) elements, n a multiple of
// `group` (a power of two, 1..128) and, at bits 4, even; packed: n (bits
// 8) or n / 2 (bits 4) int8; scales: n / group bf16.  On `stream`.
extern "C" int quantize_pack_launch(const void* x, void* packed,
                                    void* scales, long long n, int bits,
                                    int group, int is_bf16, void* stream) {
  if (bits == 8)
    return launch_pack_group<8>(x, packed, scales, n, group, is_bf16, stream);
  if (bits == 4)
    return launch_pack_group<4>(x, packed, scales, n, group, is_bf16, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// packed: n_bytes int8; scales: (n_bytes or 2 n_bytes) / group bf16;
// out: n_bytes (bits 8) or 2 n_bytes (bits 4) f32.  On `stream`.
extern "C" int unpack_dequant_launch(const void* packed, const void* scales,
                                     void* out, long long n_bytes, int bits,
                                     int group, void* stream) {
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  if (group < 1 || group > 128 || (1 << shift) != group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_for(n_bytes, kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const int8_t*>(packed);
  auto* sc = static_cast<const __nv_bfloat16*>(scales);
  auto* o = static_cast<float*>(out);
  if (bits == 8)
    unpack_dequant_kernel<8><<<grid, kThreads, 0, s>>>(p, sc, o, n_bytes,
                                                       shift);
  else if (bits == 4)
    unpack_dequant_kernel<4><<<grid, kThreads, 0, s>>>(p, sc, o, n_bytes,
                                                       shift);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
