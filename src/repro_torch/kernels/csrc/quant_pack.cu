// Group-quantized pack and unpack of the quantized collectives' payloads,
// for Hopper (sm_90a): the wire format of ar_quant = int8 | int4 (and of
// the legacy compress_slow / quant_ag knobs at int8, group 128).
//
// Replaces the TPU kernels src/repro/kernels/rd_allreduce/quant_kernel.py
// _quantize_kernel (quantize_pack_pallas) and _dequant_kernel
// (unpack_dequant_pallas), which are pinned bit for bit to the jnp
// reference kernels/rd_allreduce/quant.py.  These kernels are pinned the
// same way to their plain versions, quant_pack/ref.py (the arithmetic is
// quant_common.cuh's).  The recursive doubling over the pods does not come
// here: quant_rd_allreduce.cu packs, exchanges and unpacks in one launch.
//
// Pack.  x is n contiguous elements (rows of D, D a multiple of the group,
// so a group never crosses a row), f32 or bf16.  For every group of
// `group` consecutive elements (a power of two, 1..128) it stores q as
// int8 (bits 8, qmax 127) or as nibble pairs (bits 4, qmax 7): byte i =
// (q[2i] & 0xF) | (q[2i+1] & 0xF) << 4, and the scale rounded to bf16.
// With `err` it also writes err = x - q * bf16(scale) in f32 (the error
// feedback of the reduce-scatter), which saves the EF stage's own unpack
// and subtraction.
//
// Unpack.  The payload and scales are strided views whose last dim is
// contiguous (the all-to-all's transpose and the all-gather's broadcast
// reach it with no copy), optionally with a piece dim of n pieces that it
// sums in index order (the reduce-scatter's receive and sum in one pass);
// the f32 output is a strided view too, so the all-gather writes its
// pieces where the gathered tensor wants them.
//
// Layout of the work.  Pack: one warp a tile of 256 elements, each lane
// owning a run of 4 adjacent ones in each half (quant_common.cuh: every
// 16-byte access of a half is contiguous across the warp, and an int4
// pair never straddles lanes); a group of 4..128 spans group / 4 aligned
// lanes of a half and its absmax is reduced with xor shuffles, groups of
// 1 and 2 stay inside a run.  Unpack: one thread a run of 4 output
// elements of a row, grid.y over rows (their offsets computed once a row
// from the collapsed sizes and strides), grid.x over a row.
//
// What bounds them on an H100: bytes (a few operations an element).  Pack
// reads 4 (or 2) bytes an element and writes 1 (or 1/2) plus 2/group (and
// 4 with err); unpack the reverse with a 4-byte f32 output.  Loads and
// stores are 16-byte vectors where the pointers and strides allow (the
// wrappers check), with a scalar tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using namespace quant;

constexpr int kThreads = 256;
constexpr int kMaxDims = 6;             // MAX_DIMS in quant_pack/ops.py
constexpr long long kMaxCtas = 132LL * 16;   // a few waves of CTAs

template <int BITS, int GROUP, typename T>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ packed,
                     __nv_bfloat16* __restrict__ scales,
                     float* __restrict__ err, long long n, int vec) {
  constexpr int kSub = GROUP >= kRun ? 1 : kRun / GROUP;   // groups a run
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const long long n_tiles = (n + kTile - 1) / kTile;
  for (long long t = warp; t < n_tiles; t += n_warps) {
    float v[kPer];
    load_lane(x, t, lane, n, vec, v);
    float sc[2][kSub];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (GROUP >= kRun) {
        float a = fabsf(v[h * kRun]);
#pragma unroll
        for (int i = 1; i < kRun; ++i) a = nan_max(a, fabsf(v[h * kRun + i]));
        sc[h][0] = group_scale<BITS>(lanes_max<GROUP / kRun>(a));
      } else {
#pragma unroll
        for (int g = 0; g < kSub; ++g) {
          float a = fabsf(v[h * kRun + g * GROUP]);
#pragma unroll
          for (int i = 1; i < GROUP; ++i)
            a = nan_max(a, fabsf(v[h * kRun + g * GROUP + i]));
          sc[h][g] = group_scale<BITS>(a);
        }
      }
    }
    int q[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      q[e] = quantize<BITS>(v[e], sc[e / kRun][(e % kRun) / GROUP % kSub]);
    const unsigned w4 = BITS == 4 ? pack_int4(q) : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e0 = run_start(t, lane, h);
      const bool full = e0 + kRun <= n;
      if constexpr (BITS == 8) {
        const unsigned w = pack_int8(q + h * kRun);
        if (full) {
          *reinterpret_cast<unsigned*>(packed + e0) = w;
        } else {
#pragma unroll
          for (int i = 0; i < kRun; ++i)
            if (e0 + i < n) packed[e0 + i] = static_cast<int8_t>(w >> (8 * i));
        }
      } else {
        const unsigned short w = static_cast<unsigned short>(w4 >> (16 * h));
        if (full) {
          *reinterpret_cast<unsigned short*>(packed + e0 / 2) = w;
        } else {
#pragma unroll
          for (int i = 0; i < kRun; i += 2)
            if (e0 + i < n)
              packed[(e0 + i) / 2] = static_cast<int8_t>(w >> (4 * i));
        }
      }
      __nv_bfloat16 sb[kSub];
#pragma unroll
      for (int g = 0; g < kSub; ++g) sb[g] = __float2bfloat16_rn(sc[h][g]);
      if constexpr (GROUP >= kRun) {
        if (lane % (GROUP / kRun) == 0 && e0 < n) scales[e0 / GROUP] = sb[0];
      } else if (full) {
        // 4 / GROUP scales at scales + e0 / GROUP: 8 or 4 bytes, aligned
        if constexpr (GROUP == 1) {
          uint2 w;
          memcpy(&w, sb, sizeof(w));
          *reinterpret_cast<uint2*>(scales + e0) = w;
        } else {
          unsigned w;
          memcpy(&w, sb, sizeof(w));
          *reinterpret_cast<unsigned*>(scales + e0 / 2) = w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < kSub; ++g)
          if (e0 + g * GROUP < n) scales[e0 / GROUP + g] = sb[g];
      }
      if (err != nullptr) {
        float r[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          r[i] = __fsub_rn(v[h * kRun + i],
                           deq(q[h * kRun + i],
                               __bfloat162float(sb[i / GROUP % kSub])));
        store4(err, e0, n, true, r);
      }
    }
  }
}

// The unpack's view geometry (see unpack_dequant_launch for the layout of
// the int64 array it is read from).
struct UnpackGeom {
  long long size[kMaxDims];
  long long ps[kMaxDims], ss[kMaxDims], os[kMaxDims];
  long long rows, D, piece_ps, piece_ss;
  int ndim, pieces, group_shift, vec;
};

// q of element j of a payload row (BITS 8: byte j; BITS 4: nibble j).
template <int BITS>
__device__ __forceinline__ int q_at(const int8_t* row, long long j) {
  if constexpr (BITS == 8) return row[j];
  else
    return int4_at(static_cast<unsigned char>(row[j >> 1]),
                   static_cast<int>(j & 1));
}

// The 4 dequantized elements j0..j0+4 of one piece's row (zeros past D).
template <int BITS>
__device__ __forceinline__ void deq4(const int8_t* prow,
                                     const __nv_bfloat16* srow, long long j0,
                                     const UnpackGeom& g, float (&d)[kRun]) {
  if (g.vec && j0 + kRun <= g.D) {
    int q[kRun];
    if constexpr (BITS == 8) {
      const unsigned w = *reinterpret_cast<const unsigned*>(prow + j0);
#pragma unroll
      for (int i = 0; i < kRun; ++i) q[i] = int8_at(w, i);
    } else {
      const unsigned w =
          *reinterpret_cast<const unsigned short*>(prow + j0 / 2);
#pragma unroll
      for (int i = 0; i < kRun; ++i) q[i] = int4_at(w, i);
    }
    if (g.group_shift >= 2) {           // one group covers the run
      const float s = __bfloat162float(srow[j0 >> g.group_shift]);
#pragma unroll
      for (int i = 0; i < kRun; ++i) d[i] = deq(q[i], s);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        d[i] = deq(q[i], __bfloat162float(srow[(j0 + i) >> g.group_shift]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const long long j = j0 + i;
    d[i] = j < g.D ? deq(q_at<BITS>(prow, j),
                         __bfloat162float(srow[j >> g.group_shift]))
                   : 0.f;
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_kernel(const int8_t* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ scales,
                      float* __restrict__ out, const UnpackGeom g) {
  const long long runs = (g.D + kRun - 1) / kRun;     // a row's
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    long long po = 0, so = 0, oo = 0, r = row;
    for (int d = g.ndim - 1; d >= 0; --d) {
      const long long i = r % g.size[d];
      r /= g.size[d];
      po += i * g.ps[d];
      so += i * g.ss[d];
      oo += i * g.os[d];
    }
    for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         c < runs; c += static_cast<long long>(gridDim.x) * kThreads) {
      const long long j0 = c * kRun;
      float acc[kRun];
      deq4<BITS>(packed + po, scales + so, j0, g, acc);
      // the pieces summed in index order, each sum rounded
      for (int p = 1; p < g.pieces; ++p) {
        float d[kRun];
        deq4<BITS>(packed + po + p * g.piece_ps, scales + so + p * g.piece_ss,
                   j0, g, d);
#pragma unroll
        for (int i = 0; i < kRun; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
      }
      store4(out + oo, j0, g.D, g.vec, acc);
    }
  }
}

int grid_for(long long work, int per_block) {
  long long g = (work + per_block - 1) / per_block;
  return static_cast<int>(g < 1 ? 1 : (g > kMaxCtas ? kMaxCtas : g));
}

template <int BITS, int GROUP>
int launch_pack(const void* x, void* packed, void* scales, void* err,
                long long n, int is_bf16, int vec, void* stream) {
  const int grid = grid_for((n + kTile - 1) / kTile, kThreads / 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<int8_t*>(packed);
  auto* sc = static_cast<__nv_bfloat16*>(scales);
  auto* e = static_cast<float*>(err);
  if (is_bf16)
    quantize_pack_kernel<BITS, GROUP, __nv_bfloat16>
        <<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), p, sc, e, n, vec);
  else
    quantize_pack_kernel<BITS, GROUP, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), p, sc, e, n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_pack_group(const void* x, void* packed, void* scales, void* err,
                      long long n, int group, int is_bf16, int vec,
                      void* stream) {
#define QP_CASE(G) \
  case G:                                                                   \
    return launch_pack<BITS, G>(x, packed, scales, err, n, is_bf16, vec,    \
                                stream);
  switch (group) {
    QP_CASE(1) QP_CASE(2) QP_CASE(4) QP_CASE(8) QP_CASE(16) QP_CASE(32)
    QP_CASE(64) QP_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QP_CASE
}

}  // namespace

// x: n contiguous f32 (bf16 when is_bf16) elements, n a multiple of
// `group` (a power of two, 1..128) and, at bits 4, even; vec: x is 16-byte
// aligned; packed: n (bits 8) or n / 2 (bits 4) int8; scales: n / group
// bf16; err: n f32 or null.  packed, scales and err 16-byte aligned.  On
// `stream`.
extern "C" int quantize_pack_launch(const void* x, void* packed,
                                    void* scales, void* err, long long n,
                                    int bits, int group, int is_bf16, int vec,
                                    void* stream) {
  if (bits == 8)
    return launch_pack_group<8>(x, packed, scales, err, n, group, is_bf16,
                                vec, stream);
  if (bits == 4)
    return launch_pack_group<4>(x, packed, scales, err, n, group, is_bf16,
                                vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// geom (int64): [ndim, pieces, group, vec, D, piece_ps, piece_ss, then for
// each of ndim row dims, outermost first: size, payload stride (bytes),
// scale stride, out stride (elements)].  A row holds D output elements
// (D / group scales, D or D / 2 payload bytes, all contiguous); the row
// dims' product is the number of rows.  vec: payload pointer and strides
// multiples of 4 (bits 8) or 2 (bits 4) bytes, out pointer 16-byte aligned
// and its strides multiples of 4 elements.  On `stream`.
extern "C" int unpack_dequant_launch(const void* packed, const void* scales,
                                     void* out, const long long* geom,
                                     int bits, void* stream) {
  UnpackGeom g{};
  g.ndim = static_cast<int>(geom[0]);
  g.pieces = static_cast<int>(geom[1]);
  const long long group = geom[2];
  g.vec = static_cast<int>(geom[3]);
  g.D = geom[4];
  g.piece_ps = geom[5];
  g.piece_ss = geom[6];
  int shift = 0;
  while ((1LL << shift) < group) ++shift;
  if (g.ndim < 0 || g.ndim > kMaxDims || g.pieces < 1 || group < 1 ||
      group > 128 || (1LL << shift) != group || g.D < 1 || g.D % group)
    return static_cast<int>(cudaErrorInvalidValue);
  g.group_shift = shift;
  g.rows = 1;
  for (int d = 0; d < g.ndim; ++d) {
    g.size[d] = geom[7 + 4 * d];
    g.ps[d] = geom[8 + 4 * d];
    g.ss[d] = geom[9 + 4 * d];
    g.os[d] = geom[10 + 4 * d];
    if (g.size[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g.rows *= g.size[d];
  }
  const long long runs = (g.D + kRun - 1) / kRun;
  const int gy = static_cast<int>(g.rows < 65535 ? g.rows : 65535);
  long long gx = (runs + kThreads - 1) / kThreads;
  const long long gx_cap = kMaxCtas / gy > 1 ? kMaxCtas / gy : 1;
  gx = gx < gx_cap ? gx : gx_cap;
  const dim3 grid(static_cast<unsigned>(gx), gy);
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const int8_t*>(packed);
  auto* sc = static_cast<const __nv_bfloat16*>(scales);
  auto* o = static_cast<float*>(out);
  if (bits == 8)
    unpack_dequant_kernel<8><<<grid, kThreads, 0, s>>>(p, sc, o, g);
  else if (bits == 4)
    unpack_dequant_kernel<4><<<grid, kThreads, 0, s>>>(p, sc, o, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
