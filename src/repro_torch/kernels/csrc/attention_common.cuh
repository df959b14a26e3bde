// Shared device code of the port's attention kernels (flash prefill, dense
// decode, paged decode), also used by the grouped expert FFN: 16-byte
// operand loads widened to f32, the f32 online-softmax update, and the
// error string the Python wrappers report (the scan kernels include it for
// that string).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// Finite "minus infinity", as in the JAX kernels (kernel.py NEG_INF): a
// fully masked row stays finite instead of turning into NaN.
constexpr float kNegInf = -1.0e30f;
// The final division uses max(l, kMinDenom), as the JAX kernels do.
constexpr float kMinDenom = 1.0e-30f;

template <typename T>
struct Vec16 {
  // Elements of T in one 16-byte load.
  static constexpr int n = 16 / sizeof(T);
};

// Load 16 bytes of T from global memory (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The one online-softmax step all three kernels share.  Folds a tile whose
// masked, scaled scores have row maximum `tile_max` and (after the caller
// exponentiates them against the returned max) row sum into the running
// state (m, l).  Returns alpha, the factor that rescales the accumulator
// and the old l:  m' = max(m, tile_max), alpha = exp(m - m').
__device__ __forceinline__ float softmax_rescale(float& m, float tile_max) {
  const float m_new = fmaxf(m, tile_max);
  const float alpha = expf(m - m_new);
  m = m_new;
  return alpha;
}

__device__ __forceinline__ float warp_max(float x, int width) {
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, int width) {
  for (int o = width / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace attn

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
