// Device helpers of the group-quantized wire, shared by the standalone
// pack / unpack kernels (quant_pack.cu) and the quantized recursive-doubling
// all-reduce (quant_rd_allreduce.cu): the contract of quant_pack/ref.py.
//
//   scale = max(absmax / qmax, 1e-30)          (f32, IEEE division)
//   q     = clip(rint(x / scale), -qmax, qmax) (f32 scale, half to even)
//   deq   = q * bf16(scale)                    (one f32 multiply)
//
// Every division, product and sum here goes through the _rn intrinsics, so
// nvcc never contracts a dequantized product and the add that follows it
// into one fused multiply-add: the plain versions round both.  fmaxf would
// drop a NaN where torch.amax keeps it, so the absmax and the eps clamp go
// through nan_max: a NaN or Inf makes its own group's scale non-finite and
// every dequantized element of that group non-finite, and no other.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exchange_common.cuh"

namespace quant {

using exchange::from_f;
using exchange::to_f;

constexpr float kEps = 1e-30f;
constexpr int kPer = 8;     // elements a lane a tile: two runs (below)

template <int BITS>
constexpr int kQmax = BITS == 8 ? 127 : 7;

// max that keeps a NaN from either side, as torch.amax / torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int BITS>
__device__ __forceinline__ float group_scale(float absmax) {
  return nan_max(__fdiv_rn(absmax, static_cast<float>(kQmax<BITS>)), kEps);
}

template <int BITS>
__device__ __forceinline__ int quantize(float v, float scale) {
  // NaN converts to 0 here; its group's payload is unspecified anyway
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return q > kQmax<BITS> ? kQmax<BITS> : (q < -kQmax<BITS> ? -kQmax<BITS> : q);
}

// The absmax of a group that spans LANES aligned lanes (a power of two),
// reduced with xor shuffles; every lane of the warp must take part.
template <int LANES>
__device__ __forceinline__ float lanes_max(float a) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ float deq(int q, float scale_bf16) {
  return __fmul_rn(static_cast<float>(q), scale_bf16);
}

// q[0..3] as the 4 bytes of an int8 word, element 0 in the low byte
__device__ __forceinline__ unsigned pack_int8(const int* q) {
  return (q[0] & 0xFF) | (q[1] & 0xFF) << 8 | (q[2] & 0xFF) << 16 |
         static_cast<unsigned>(q[3] & 0xFF) << 24;
}

// q[0..7] as the 8 nibbles of an int4 word: byte i = q[2i] | q[2i+1] << 4
__device__ __forceinline__ unsigned pack_int4(const int* q) {
  unsigned w = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) w |= static_cast<unsigned>(q[e] & 0xF) << (4 * e);
  return w;
}

// sign-extended byte i / nibble i of a word
__device__ __forceinline__ int int8_at(unsigned w, int i) {
  return static_cast<int>(w << (24 - 8 * i)) >> 24;
}
__device__ __forceinline__ int int4_at(unsigned w, int i) {
  return static_cast<int>(w << (28 - 4 * i)) >> 28;
}

// A warp's tile is 256 elements, two halves of 128; lane l owns the run of
// kRun = 4 elements at l * 4 of each half, its elements 0..3 in the first
// half and 4..7 in the second.  Every 16-byte access of a half is then
// contiguous across the warp: stores write whole 32-byte sectors.
constexpr int kRun = 4;
constexpr int kTile = 2 * 32 * kRun;

__device__ __forceinline__ long long run_start(long long tile, int lane,
                                               int half) {
  return tile * kTile + half * (kTile / 2) + lane * kRun;
}

// The 4 elements at row[e..e+4) as f32, zeros at and past m.  vec: the row
// start is 16-byte aligned, so a full run (e a multiple of 4) is one
// 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ void load4(const float* row, long long e,
                                      long long m, bool vec, float* v) {
  if (vec && e + kRun <= m) {
    const float4 a = *reinterpret_cast<const float4*>(row + e);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) v[i] = e + i < m ? row[e + i] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* row, long long e,
                                      long long m, bool vec, float* v) {
  if (vec && e + kRun <= m) {
    const uint2 a = *reinterpret_cast<const uint2*>(row + e);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xFFFF0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xFFFF0000u);
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    v[i] = e + i < m ? __bfloat162float(row[e + i]) : 0.f;
}

// v[0..4) to row[e..), only below m; vec as for load4.
__device__ __forceinline__ void store4(float* row, long long e, long long m,
                                       bool vec, const float* v) {
  if (vec && e + kRun <= m) {
    *reinterpret_cast<float4*>(row + e) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (e + i < m) row[e + i] = v[i];
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, long long e,
                                       long long m, bool vec, const float* v) {
  if (vec && e + kRun <= m) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    memcpy(&w.x, &a, 4);
    memcpy(&w.y, &b, 4);
    *reinterpret_cast<uint2*>(row + e) = w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (e + i < m) row[e + i] = __float2bfloat16_rn(v[i]);
}

// A lane's 8 elements of tile `tile` of a row of m (zeros past m), and
// back (only below m).
template <typename T>
__device__ __forceinline__ void load_lane(const T* row, long long tile,
                                          int lane, long long m, bool vec,
                                          float (&v)[kPer]) {
  load4(row, run_start(tile, lane, 0), m, vec, v);
  load4(row, run_start(tile, lane, 1), m, vec, v + kRun);
}

template <typename T>
__device__ __forceinline__ void store_lane(T* row, long long tile, int lane,
                                           long long m, bool vec,
                                           const float (&v)[kPer]) {
  store4(row, run_start(tile, lane, 0), m, vec, v);
  store4(row, run_start(tile, lane, 1), m, vec, v + kRun);
}

}  // namespace quant
