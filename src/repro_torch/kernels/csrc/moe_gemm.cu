// Grouped expert FFN (gated SiLU) of the MoE layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/kernel.py
// _moe_ffn_kernel (moe_expert_ffn_call): for every expert e and every row c
// of its token buffer
//     out[e, c] = (silu(x[e, c] @ wg[e]) * (x[e, c] @ wu[e])) @ wd[e]
// with x (G, C, D) (expert e reads x[e / (E / G)]; G == E is the TPU
// kernel's contract, G < E lets the decode path hand every expert of a rank
// one shared token block without E copies), wg/wu (E, D, F), wd (E, F, D),
// out (E, C, D) in the operands' type.  Gate, up, h and the down
// projection's sum are f32; h never goes to device memory.
//
// What bounds it on an H100: at the decode shapes, bytes.  Every expert's
// three weight matrices are read once a call (qwen3-moe-30b-a3b: 128 x 3 x
// 2048 x 768 bf16 = 1.21 GB a layer, 0.36 ms at 3.35 TB/s) and used for C
// = 8 token rows.  At the prefill shape (C = 80) the 6 E C D F operations
// dominate: this kernel does them as f32 FMAs on the CUDA cores, not on the
// tensor cores (a wgmma/TMA version is later work).
//
// Design:
//  * one CTA per (token tile of kBC = 8 rows, expert); the grid walks the
//    tiles of one expert next to each other, so the C / kBC CTAs of an
//    expert share its weights through L2;
//  * the CTA walks F in tiles of kBF = 64 columns.  Half the threads sum
//    the gate tile, half the up tile: each thread owns 8 adjacent columns
//    (one 16-byte load of wg or wu along F a row) and every 16th row of D;
//    the 16 row groups are summed by two xor shuffles inside a warp and a
//    fixed-order sum over the 4 warps of a half in shared memory.  h =
//    silu(g) * u of the tile goes to shared memory;
//  * the down projection streams wd rows along D with 16-byte loads, each
//    thread owning 8 columns of D for all kBC rows, and adds into the
//    (kBC, D) f32 accumulator kept in shared memory between F tiles (in
//    registers within a tile).  Small kBC with the full D, rather than D
//    split across CTAs: splitting D would recompute h, re-reading wg and wu
//    once per split, which at decode is the whole cost;
//  * every sum runs in a fixed order (no atomics), so the result is
//    bitwise repeatable;
//  * token rows past C are zero in shared memory and never stored; F and D
//    remainders are masked in the loads (the 16-byte path needs D and F
//    multiples of 8 and aligned operands, else an element-wise path runs).
// Shared memory: kBC D (4 + sizeof(T)) + 18 KB, 114 KB at D = 2048 bf16.
//
// A d_model whose (kBC, D) accumulator and token rows do not fit one CTA's
// 227 KB (past D ~3300 in f32, ~4400 in bf16; dbrx-132b has 6144) takes
// two launches that stage h instead of recomputing it: moe_h_kernel, one
// CTA per (token tile, F tile, expert), sums the gate and up tile over D
// with the token rows staged dt columns at a time and writes h in f32 to
// a scratch (E, C, F) the wrapper allocates; moe_down_kernel, one CTA per
// (token tile, dt columns of D, expert), runs the down projection over
// every F tile into its (kBC, dt) accumulator.  Each thread runs the
// same FMAs in the same order as in the one-launch kernel (dt is a
// multiple of its 2048-column down pass and of the 16 row groups), so the
// two forms give bitwise the same output.  wg and wu are read once, wd
// once a token tile, h (E C F f32) written and read once.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBC = 8;                     // token rows a CTA
constexpr int kBF = 64;                    // F columns a tile
constexpr int kCols = 8;                   // adjacent columns a thread
constexpr int kHalf = kThreads / 2;        // threads on gate (and on up)
constexpr int kFG = kBF / kCols;           // column groups of a tile: 8
constexpr int kDG = kHalf / kFG;           // row groups of the D sum: 16
constexpr int kWarpsHalf = kHalf / 32;     // warps of a half: 4
constexpr int kDownCols = kThreads * kCols;  // D columns a down pass: 2048
constexpr unsigned kFull = 0xffffffffu;

// 8 adjacent elements at p widened to f32, the first n of them real (the
// rest zero).  VEC: p is 16-byte aligned whenever n > 0, and n is 0 or 8.
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* __restrict__ p, int n,
                                      float (&v)[kCols]) {
  if (VEC) {
    if (n > 0) {
#pragma unroll
      for (int i = 0; i < kCols; i += attn::Vec16<T>::n)
        attn::load16(p + i, v + i);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      v[j] = j < n ? attn::to_f32(__ldg(p + j)) : 0.f;
  }
}

size_t smem_bytes(int D, size_t esz) {
  return static_cast<size_t>(kBC) * D * (sizeof(float) + esz) +
         (2 * kWarpsHalf * kBC * kBF + kBC * kBF) * sizeof(float);
}

size_t tiled_smem_bytes(int dt, size_t esz, bool h_pass) {
  return h_pass ? static_cast<size_t>(kBC) * dt * esz +
                      (2 * kWarpsHalf * kBC * kBF + kBC * kBF) * sizeof(float)
                : (static_cast<size_t>(kBC) * dt + kBC * kBF) * sizeof(float);
}

// The two-launch form's pieces.  Each repeats, operation for operation, a
// loop of moe_ffn_kernel below (which keeps its own inline copy: folding
// it onto these helpers cost its f32 instantiations 8-17% on the card).
//
// s[c][j] += x[c, d] * w[d, fcol + j] over this thread's rows d = d0 + dg,
// d0 + dg + kDG, ... < d1, with x[c, d] at xs[c * xld + d - d0].
template <typename T, bool VEC>
__device__ __forceinline__ void gate_up_rows(const T* __restrict__ wh,
                                             const T* xs, int xld, int d0,
                                             int d1, int dg, int F, int fcol,
                                             int ncol,
                                             float (&s)[kBC][kCols]) {
#pragma unroll 4
  for (int d = d0 + dg; d < d1; d += kDG) {
    float w[kCols];
    load8<T, VEC>(wh + static_cast<long long>(d) * F + fcol, ncol, w);
#pragma unroll
    for (int c = 0; c < kBC; ++c) {
      const float xv = attn::to_f32(xs[c * xld + d - d0]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[c][j] = fmaf(xv, w[j], s[c][j]);
    }
  }
}

// The row groups' partial gate and up sums of a tile to h = silu(g) * u in
// hs (kBC, kBF): the 4 row groups of a warp (lanes l, l^8, l^16, l^24),
// then the 4 warps of a half, in a fixed order.
__device__ __forceinline__ void tile_h(float (&s)[kBC][kCols], float* red,
                                       float* hs) {
  const int t = threadIdx.x;
  const int half = t / kHalf, fg = (t % kHalf) % kFG;
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int c = 0; c < kBC; ++c)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = s[c][j];
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 16);
      s[c][j] = v;
    }
  if (lane < kFG) {
    float* r = red + (half * kWarpsHalf + warp % kWarpsHalf) * kBC * kBF;
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j) r[c * kBF + fg * kCols + j] = s[c][j];
  }
  __syncthreads();
  for (int i = t; i < kBC * kBF; i += kThreads) {
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsHalf; ++w) {
      g += red[w * kBC * kBF + i];
      u += red[(kWarpsHalf + w) * kBC * kBF + i];
    }
    hs[i] = g / (1.f + expf(-g)) * u;   // silu(g) * u; zero past F
  }
  __syncthreads();
}

// acc[c, d - d_lo] += sum over the tile's f < nf of h[c, f] * wd[f0 + f, d]
// for this thread's columns d = d_lo + 8 t + kDownCols i < d_hi (acc row
// stride ald).
template <typename T, bool VEC>
__device__ __forceinline__ void down_rows(float* acc, int ald, const float* hs,
                                          const T* __restrict__ wde, int f0,
                                          int nf, int d_lo, int d_hi, int D) {
  for (int d0 = d_lo + threadIdx.x * kCols; d0 < d_hi; d0 += kDownCols) {
    const int nd = min(kCols, d_hi - d0);
    float* ar = acc + d0 - d_lo;
    float a[kBC][kCols];
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[c][j] = j < nd ? ar[c * ald + j] : 0.f;
#pragma unroll 4
    for (int f = 0; f < nf; ++f) {
      float w[kCols];
      load8<T, VEC>(wde + static_cast<long long>(f0 + f) * D + d0, nd, w);
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        const float hv = hs[c * kBF + f];
#pragma unroll
        for (int j = 0; j < kCols; ++j) a[c][j] = fmaf(hv, w[j], a[c][j]);
      }
    }
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nd) ar[c * ald + j] = a[c][j];
  }
}

// The thread's gate (first half) or up (second half) column group: its
// 8 columns from fcol, ncol of them inside F, and its row group dg.
struct Role {
  int dg, fcol, ncol;
  __device__ Role(int f0, int F) {
    const int lt = threadIdx.x % kHalf;
    dg = lt / kFG;
    fcol = f0 + (lt % kFG) * kCols;
    ncol = max(0, min(kCols, F - fcol));
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_ffn_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               T* __restrict__ out, int C, int D, int F, int x_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);       // (kBC, D)
  float* red = acc + kBC * D;            // (2, kWarpsHalf, kBC, kBF)
  float* hs = red + 2 * kWarpsHalf * kBC * kBF;          // (kBC, kBF)
  T* xs = reinterpret_cast<T*>(hs + kBC * kBF);          // (kBC, D)

  const int e = blockIdx.y;
  const int c0 = blockIdx.x * kBC;
  const int nc = min(kBC, C - c0);
  const int t = threadIdx.x;
  const long long df = static_cast<long long>(D) * F;
  const T* xe = x + (static_cast<long long>(e / x_group) * C + c0) * D;
  const T* wge = wg + e * df;
  const T* wue = wu + e * df;
  const T* wde = wd + e * df;

  for (int i = t; i < kBC * D; i += kThreads) {
    xs[i] = i < nc * D ? xe[i] : attn::from_f32<T>(0.f);
    acc[i] = 0.f;
  }
  __syncthreads();

  const int half = t / kHalf;            // 0: gate, 1: up
  const int lt = t % kHalf;
  const int fg = lt % kFG;
  const int dg = lt / kFG;
  const int warp = t / 32;
  const int lane = t % 32;
  const T* wh = half ? wue : wge;

  for (int f0 = 0; f0 < F; f0 += kBF) {
    // gate or up: s[c][j] = sum over this thread's rows d of
    // x[c, d] * w[d, f0 + fg * kCols + j]
    const int fcol = f0 + fg * kCols;
    const int ncol = max(0, min(kCols, F - fcol));
    float s[kBC][kCols];
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[c][j] = 0.f;
#pragma unroll 4
    for (int d = dg; d < D; d += kDG) {
      float w[kCols];
      load8<T, VEC>(wh + static_cast<long long>(d) * F + fcol, ncol, w);
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        const float xv = attn::to_f32(xs[c * D + d]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[c][j] = fmaf(xv, w[j], s[c][j]);
      }
    }
    // the 4 row groups of a warp (lanes l, l^8, l^16, l^24), then the 4
    // warps of a half, in a fixed order
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float v = s[c][j];
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        s[c][j] = v;
      }
    if (lane < kFG) {
      float* r = red + (half * kWarpsHalf + warp % kWarpsHalf) * kBC * kBF;
#pragma unroll
      for (int c = 0; c < kBC; ++c)
#pragma unroll
        for (int j = 0; j < kCols; ++j) r[c * kBF + fg * kCols + j] = s[c][j];
    }
    __syncthreads();
    for (int i = t; i < kBC * kBF; i += kThreads) {
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsHalf; ++w) {
        g += red[w * kBC * kBF + i];
        u += red[(kWarpsHalf + w) * kBC * kBF + i];
      }
      hs[i] = g / (1.f + expf(-g)) * u;   // silu(g) * u; zero past F
    }
    __syncthreads();

    // down: acc[c, d] += sum over the tile's f of h[c, f] * wd[f0 + f, d]
    const int nf = min(kBF, F - f0);
    for (int d0 = t * kCols; d0 < D; d0 += kDownCols) {
      const int nd = min(kCols, D - d0);
      float a[kBC][kCols];
#pragma unroll
      for (int c = 0; c < kBC; ++c)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          a[c][j] = j < nd ? acc[c * D + d0 + j] : 0.f;
#pragma unroll 4
      for (int f = 0; f < nf; ++f) {
        float w[kCols];
        load8<T, VEC>(wde + static_cast<long long>(f0 + f) * D + d0, nd, w);
#pragma unroll
        for (int c = 0; c < kBC; ++c) {
          const float hv = hs[c * kBF + f];
#pragma unroll
          for (int j = 0; j < kCols; ++j) a[c][j] = fmaf(hv, w[j], a[c][j]);
        }
      }
#pragma unroll
      for (int c = 0; c < kBC; ++c)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < nd) acc[c * D + d0 + j] = a[c][j];
    }
    __syncthreads();   // red and hs are rewritten by the next tile
  }

  T* oe = out + (static_cast<long long>(e) * C + c0) * D;
  for (int i = t; i < nc * D; i += kThreads) oe[i] = attn::from_f32<T>(acc[i]);
}

// h[e, c0 + c, f0 + f] of one (token tile, F tile, expert), in f32, for a
// D too wide for the one-launch kernel: the token rows staged dt columns
// at a time.  blockIdx.x = token tile * F tiles + F tile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_h_kernel(const T* __restrict__ x, const T* __restrict__ wg,
             const T* __restrict__ wu, float* __restrict__ h, int C, int D,
             int F, int x_group, int dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);
  float* hs = red + 2 * kWarpsHalf * kBC * kBF;          // (kBC, kBF)
  T* xs = reinterpret_cast<T*>(hs + kBC * kBF);          // (kBC, dt)

  const int n_ft = (F + kBF - 1) / kBF;
  const int e = blockIdx.y;
  const int c0 = (blockIdx.x / n_ft) * kBC;
  const int f0 = (blockIdx.x % n_ft) * kBF;
  const int nc = min(kBC, C - c0);
  const int t = threadIdx.x;
  const long long df = static_cast<long long>(D) * F;
  const T* xe = x + (static_cast<long long>(e / x_group) * C + c0) * D;
  const T* wh = (t / kHalf ? wu : wg) + e * df;

  const Role ro(f0, F);
  float s[kBC][kCols];
#pragma unroll
  for (int c = 0; c < kBC; ++c)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[c][j] = 0.f;
  for (int x0 = 0; x0 < D; x0 += dt) {
    const int nx = min(dt, D - x0);
    __syncthreads();   // the previous piece's reads are done
    for (int i = t; i < kBC * dt; i += kThreads) {
      const int c = i / dt, j = i % dt;
      xs[i] = c < nc && j < nx ? xe[static_cast<long long>(c) * D + x0 + j]
                               : attn::from_f32<T>(0.f);
    }
    __syncthreads();
    gate_up_rows<T, VEC>(wh, xs, dt, x0, x0 + nx, ro.dg, F, ro.fcol,
                         ro.ncol, s);
  }
  tile_h(s, red, hs);
  const int nf = min(kBF, F - f0);
  float* he = h + (static_cast<long long>(e) * C + c0) * F + f0;
  for (int i = t; i < nc * kBF; i += kThreads) {
    const int c = i / kBF, f = i % kBF;
    if (f < nf) he[static_cast<long long>(c) * F + f] = hs[i];
  }
}

// out[e, c0 + c, d] for d in [d_lo, d_lo + dt) from h, every F tile in
// order.  blockIdx.x = token tile * D tiles + D tile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const float* __restrict__ h, const T* __restrict__ wd,
                T* __restrict__ out, int C, int D, int F, int dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);       // (kBC, dt)
  float* hs = acc + kBC * dt;                            // (kBC, kBF)

  const int n_dt = (D + dt - 1) / dt;
  const int e = blockIdx.y;
  const int c0 = (blockIdx.x / n_dt) * kBC;
  const int d_lo = (blockIdx.x % n_dt) * dt;
  const int d_hi = min(D, d_lo + dt);
  const int nc = min(kBC, C - c0);
  const int t = threadIdx.x;
  const T* wde = wd + e * static_cast<long long>(D) * F;
  const float* he = h + (static_cast<long long>(e) * C + c0) * F;

  for (int i = t; i < kBC * dt; i += kThreads) acc[i] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kBF) {
    const int nf = min(kBF, F - f0);
    __syncthreads();   // the previous tile's reads of hs are done
    for (int i = t; i < kBC * kBF; i += kThreads) {
      const int c = i / kBF, f = i % kBF;
      hs[i] = c < nc && f < nf ? he[static_cast<long long>(c) * F + f0 + f]
                               : 0.f;
    }
    __syncthreads();
    down_rows<T, VEC>(acc, dt, hs, wde, f0, nf, d_lo, d_hi, D);
  }
  __syncthreads();
  T* oe = out + (static_cast<long long>(e) * C + c0) * D;
  for (int i = t; i < nc * dt; i += kThreads) {
    const int c = i / dt, d = d_lo + i % dt;
    if (d < d_hi)
      oe[static_cast<long long>(c) * D + d] = attn::from_f32<T>(acc[i]);
  }
}

// Raise a kernel's dynamic shared memory limit to smem once it is needed.
template <class K>
cudaError_t allow_smem(K kern, size_t smem, size_t* configured) {
  if (smem <= *configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) *configured = smem;
  return e;
}

template <typename T, bool VEC>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, void* h, int E, int C, int D, int F, int G, int dt,
           void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || G <= 0 || E % G || dt <= 0 ||
      (dt < D && (dt % kDownCols || !h)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ct = (C + kBC - 1) / kBC;
  if (dt >= D) {
    const size_t smem = smem_bytes(D, sizeof(T));
    static size_t configured = 48 * 1024;  // per template instance
    cudaError_t e = allow_smem(moe_ffn_kernel<T, VEC>, smem, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    moe_ffn_kernel<T, VEC><<<dim3(ct, E), kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(wu), static_cast<const T*>(wd),
        static_cast<T*>(out), C, D, F, E / G);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem_h = tiled_smem_bytes(dt, sizeof(T), true);
  const size_t smem_d = tiled_smem_bytes(dt, sizeof(T), false);
  static size_t conf_h = 48 * 1024, conf_d = 48 * 1024;
  cudaError_t e = allow_smem(moe_h_kernel<T, VEC>, smem_h, &conf_h);
  if (e == cudaSuccess)
    e = allow_smem(moe_down_kernel<T, VEC>, smem_d, &conf_d);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_ft = (F + kBF - 1) / kBF, n_dt = (D + dt - 1) / dt;
  moe_h_kernel<T, VEC><<<dim3(ct * n_ft, E), kThreads, smem_h, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<float*>(h), C, D, F, E / G, dt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  moe_down_kernel<T, VEC><<<dim3(ct * n_dt, E), kThreads, smem_d, st>>>(
      static_cast<const float*>(h), static_cast<const T*>(wd),
      static_cast<T*>(out), C, D, F, dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one CTA of the one-launch kernel at this D.
extern "C" int moe_ffn_smem_bytes(int D, int is_bf16) {
  const size_t n =
      smem_bytes(D, is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  return n > 0x7fffffff ? 0x7fffffff : static_cast<int>(n);
}

// x (G, C, D); wg/wu (E, D, F); wd (E, F, D); out (E, C, D).  All
// contiguous, one dtype (f32, or bf16 when is_bf16); vec: D and F multiples
// of 8 and every pointer 16-byte aligned.  dt: D (one launch) or a
// multiple of 2048 below D (the two launches), with h an f32 (E, C, F)
// scratch.
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* out, void* h, int E,
                              int C, int D, int F, int G, int dt,
                              int is_bf16, int vec, void* stream) {
  using bf = __nv_bfloat16;
  if (is_bf16)
    return vec ? launch<bf, true>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                  stream)
               : launch<bf, false>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                   stream);
  return vec ? launch<float, true>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                   stream)
             : launch<float, false>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                    stream);
}
