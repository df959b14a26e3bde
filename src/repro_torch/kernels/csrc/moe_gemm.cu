// Grouped expert FFN (gated SiLU) of the MoE layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/kernel.py
// _moe_ffn_kernel (moe_expert_ffn_call): for every expert e and every row c
// of its token buffer
//     out[e, c] = (silu(x[e, c] @ wg[e]) * (x[e, c] @ wu[e])) @ wd[e]
// with x (G, C, D) (expert e reads x[e / (E / G)]; G == E is the TPU
// kernel's contract, G < E lets the decode path hand every expert of a rank
// one shared token block without E copies), wg/wu (E, D, F), wd (E, F, D),
// out (E, C, D) in the operands' type.  Gate, up and the down projection's
// sums are f32.
//
// What bounds it on an H100: at the decode shapes, bytes.  Every expert's
// three weight matrices are read once a call (qwen3-moe-30b-a3b: 128 x 3 x
// 2048 x 768 bf16 = 1.21 GB a layer, 0.36 ms at 3.35 TB/s) and used for C
// = 8 token rows.  At the prefill dispatch (C = 80) the 6 E C D F = 96.6
// GFLOP take 0.098 ms at the bf16 tensor-core peak, still under the bytes.
//
// bf16: tensor cores, F split across CTAs (moe_ffn_tc_kernel, moe_ffn_tc_reduce).
//  * One CTA per (expert, F slice of kFS = 256 rows, token tile of at most
//    40 rows), so the decode shape runs 128 x 3 = 384 CTAs, two an SM,
//    instead of one CTA an expert.  The plan (slice, token tile) depends on
//    (C, D, F) only, never on G, so a shared token block gives bitwise what
//    E copies of it give; kernels/moe_gemm/ops.py::tc_plan mirrors it.
//  * Products are mma.sync m16n8k16 (csrc/mma_common.cuh) with the weights
//    as the A operand (wg[e]^T, wu[e]^T and wd[e]^T, read k-major from
//    their row-major tiles through ldmatrix.trans) and the token rows on
//    the n8 side: C = 8 is one n8 block, a 40-row tile five.
//  * The weights stream through a 4-stage cp.async ring of 16 KB stages:
//    first the gate and up tiles (16 rows of D each, with the token rows'
//    16 columns), then wd's slice rows in 32-row by 256-column tiles.
//  * h = silu(g) * u of the slice stays on chip, rounded to bf16 for the
//    down product as the JAX model layer's bf16 einsums do
//    (repro/models/moe.py::_expert_ffn; the Pallas kernel and ref.py keep
//    h in f32).
//  * The down product of a slice is an f32 partial (E, n_split, C, D) in a
//    workspace the wrapper allocates with torch.empty: 25 MB written and
//    read at the decode shape (3 slices), against 1.21 GB of weights.  A
//    second launch (programmatic dependent launch) sums the partials in
//    ascending slice order and rounds once: no atomics, so two calls are
//    bitwise equal.  The down pass tiles D inside the CTA (256 columns a
//    pass), so every d_model runs in this one design (dbrx-132b: 6144).
//  * Remainders of C, D and F are masked (zero-filled tiles, masked
//    stores); off the 16-byte path (D or F not a multiple of 8, or an
//    unaligned operand) the tiles are filled element by element.
//
// f32: the CUDA-core kernels of PRs 15 and 18, unchanged.
//  * one CTA per (token tile of kBC = 8 rows, expert); the grid walks the
//    tiles of one expert next to each other, so the C / kBC CTAs of an
//    expert share its weights through L2;
//  * the CTA walks F in tiles of kBF = 64 columns.  Half the threads sum
//    the gate tile, half the up tile: each thread owns 8 adjacent columns
//    (one 16-byte load of wg or wu along F a row) and every 16th row of D;
//    the 16 row groups are summed by two xor shuffles inside a warp and a
//    fixed-order sum over the 4 warps of a half in shared memory.  h =
//    silu(g) * u of the tile (f32) goes to shared memory;
//  * the down projection streams wd rows along D with 16-byte loads, each
//    thread owning 8 columns of D for all kBC rows, and adds into the
//    (kBC, D) f32 accumulator kept in shared memory between F tiles (in
//    registers within a tile);
//  * every sum runs in a fixed order (no atomics), so the result is
//    bitwise repeatable;
//  * token rows past C are zero in shared memory and never stored; F and D
//    remainders are masked in the loads (the 16-byte path needs D and F
//    multiples of 8 and aligned operands, else an element-wise path runs).
// Shared memory: kBC D (4 + sizeof(T)) + 18 KB.  A d_model whose (kBC, D)
// accumulator and token rows do not fit one CTA's 227 KB (past D ~3300)
// takes two launches that stage h instead of recomputing it: moe_h_kernel,
// one CTA per (token tile, F tile, expert), sums the gate and up tile over
// D with the token rows staged dt columns at a time and writes h in f32 to
// a scratch (E, C, F) the wrapper allocates; moe_down_kernel, one CTA per
// (token tile, dt columns of D, expert), runs the down projection over
// every F tile into its (kBC, dt) accumulator.  Each thread runs the same
// FMAs in the same order as in the one-launch kernel (dt is a multiple of
// its 2048-column down pass and of the 16 row groups), so the two forms
// give bitwise the same output.

#include "attention_common.cuh"
#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, F split across CTAs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kFS = 256;                  // F rows a CTA (a slice)
constexpr int kMB = kFS / kTcWarps / 16;  // m16 blocks of a warp: 2
constexpr int kDK = 16;                   // D rows a gate/up stage
constexpr int kFK = 32;                   // slice rows a down stage
constexpr int kDP = kFS;                  // D columns a down pass
constexpr int kMaxNT = 5;                 // n8 token blocks a CTA at most
constexpr int kStages = 4;
// Row strides in shared memory, padded by 16 bytes so that the 8 rows of
// an ldmatrix fall on distinct banks: the weight tiles and h^T, and the
// token rows' kDK columns.
constexpr int kWS = kFS + 8;
constexpr int kXS = kDK + 8;
constexpr int kWStage = 2 * kDK * kWS;    // weight elements a stage
static_assert(kFK * kWS == kWStage, "gate/up and down stages are equal");
static_assert(kDP == kTcWarps * kMB * 16, "a down pass: kMB m16 a warp");

// n8 token blocks a CTA for C rows: as few tiles of at most 8 kMaxNT rows
// as C needs, each of 8 NT rows (ops.py::tc_plan).
__host__ __device__ inline int tc_blocks(int C) {
  const int tiles = (C + 8 * kMaxNT - 1) / (8 * kMaxNT);
  return ((C + tiles - 1) / tiles + 7) / 8;
}

template <int NT>
struct TcTile {
  static constexpr int TC = 8 * NT;                 // token rows a CTA
  static constexpr int STAGE = kWStage + TC * kXS;  // elements a stage
  static constexpr int SMEM = 2 * (kStages * STAGE + TC * kWS);  // bytes
};

// 8 elements from src into shared memory at dst (16-byte aligned), the
// first n of them real and the rest zero: one cp.async when vec (n is 0
// or 8; base stands in for src when nothing is read), else element-wise.
__device__ __forceinline__ void fill8(bf16* dst, const bf16* src, int n,
                                      const bf16* base, bool vec) {
  if (vec) {
    tc::cp_async16(dst, n > 0 ? src : base, n > 0 ? 16 : 0);
  } else {
    alignas(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = j < n ? src[j] : __ushort_as_bfloat16(0);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// A gate/up stage: rows d0..d0+kDK-1 of wg[e] and wu[e] over the slice's
// columns f0..f0+kFS-1, then the tile's token rows over columns d0.. of x.
template <int NT>
__device__ __forceinline__ void tc_load_gu(bf16* st, const bf16* xe,
                                           const bf16* wge, const bf16* wue,
                                           int c0, int C, int D, int F,
                                           int f0, int d0, bool vec) {
  constexpr int WC = kDK * (kFS / 8);  // 16-byte pieces a matrix
#pragma unroll
  for (int u = 0; u < 2 * WC / kTcThreads; ++u) {
    const int i = threadIdx.x + u * kTcThreads;
    const int m = i / WC, k = (i % WC) / (kFS / 8), col = 8 * (i % (kFS / 8));
    const int d = d0 + k, f = f0 + col;
    const bf16* w = m ? wue : wge;
    fill8(st + (m * kDK + k) * kWS + col, w + static_cast<long long>(d) * F + f,
          d < D ? max(0, min(8, F - f)) : 0, w, vec);
  }
  bf16* xs = st + kWStage;
  for (int i = threadIdx.x; i < 2 * TcTile<NT>::TC; i += kTcThreads) {
    const int c = i / 2, d = d0 + 8 * (i % 2);
    fill8(xs + c * kXS + 8 * (i % 2),
          xe + static_cast<long long>(c0 + c) * D + d,
          c0 + c < C ? max(0, min(8, D - d)) : 0, xe, vec);
  }
}

// A down stage: slice rows f0 + kFK q .. + kFK-1 of wd[e] over columns
// dp0..dp0+kDP-1.
__device__ __forceinline__ void tc_load_down(bf16* st, const bf16* wde,
                                             int D, int F, int f0, int q,
                                             int dp0, bool vec) {
  constexpr int WC = kFK * (kDP / 8);
#pragma unroll
  for (int u = 0; u < WC / kTcThreads; ++u) {
    const int i = threadIdx.x + u * kTcThreads;
    const int k = i / (kDP / 8), col = 8 * (i % (kDP / 8));
    const int f = f0 + kFK * q + k, d = dp0 + col;
    fill8(st + k * kWS + col, wde + static_cast<long long>(f) * D + d,
          f < F ? max(0, min(8, D - d)) : 0, wde, vec);
  }
}

// B fragments of NT n8 blocks (16 k x 8 rows each) from rows stored
// k-contiguous (row stride ld), columns k0..k0+15.
template <int NT>
__device__ __forceinline__ void load_b(unsigned (&b)[NT][2], const bf16* rows,
                                       int ld, int k0, int lane) {
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) {
    unsigned r[4];
    tc::ldmatrix_x4(r, rows + ((lane & 7) + (lane >> 4) * 8 + 8 * j) * ld +
                           k0 + ((lane >> 3) & 1) * 8);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
  if constexpr (NT % 2 != 0)
    tc::ldmatrix_x2(b[NT - 1], rows + ((lane & 7) + 8 * (NT - 1)) * ld + k0 +
                                   ((lane >> 3) & 1) * 8);
}

// A fragment of one m16 block of a k-major tile (row stride kWS): rows k
// k0..k0+15, columns m0..m0+15, transposed.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile,
                                       int k0, int m0, int lane) {
  tc::ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                      kWS +
                               m0 + ((lane >> 3) & 1) * 8);
}

// One CTA: expert blockIdx.y, F slice blockIdx.x / n_tiles, token tile
// blockIdx.x % n_tiles.  Writes the slice's down product, f32, to
// part[e, slice, c, :].
template <int NT>
__global__ void __launch_bounds__(kTcThreads, 2)
moe_ffn_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const bf16* __restrict__ wd,
              float* __restrict__ part, int C, int D, int F, int x_group,
              int n_tiles, int vec) {
  using TT = TcTile<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* hT = ring + kStages * TT::STAGE;  // (TC, kWS): the slice's h^T

  const int e = blockIdx.y;
  const int split = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int n_split = gridDim.x / n_tiles;
  const int f0 = split * kFS, c0 = tile * TT::TC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long df = static_cast<long long>(D) * F;
  const bf16* xe = x + static_cast<long long>(e / x_group) * C * D;
  const bf16* wge = wg + e * df;
  const bf16* wue = wu + e * df;
  const bf16* wde = wd + e * df;
  const bool v = vec != 0;

  constexpr int kQ = kFS / kFK;  // down stages a pass
  const int n_gu = (D + kDK - 1) / kDK;
  const int n_st = n_gu + (D + kDP - 1) / kDP * kQ;
  auto load = [&](int s) {
    bf16* st = ring + (s % kStages) * TT::STAGE;
    if (s < n_gu) {
      tc_load_gu<NT>(st, xe, wge, wue, c0, C, D, F, f0, s * kDK, v);
    } else {
      const int i = s - n_gu;
      tc_load_down(st, wde, D, F, f0, i % kQ, i / kQ * kDP, v);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load(s);
    tc::cp_async_commit();
  }

  // gate (acc[0]) and up (acc[1]) of the slice, transposed: m = the warp's
  // slice rows warp * 32 + 16 i.., n = token rows 8 j..; stages in
  // ascending d
  float acc[2][kMB][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < kMB; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][i][j][r] = 0.f;
  int s = 0;
  for (; s < n_gu; ++s) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s-1's slot is free
    if (s + kStages - 1 < n_st) load(s + kStages - 1);
    tc::cp_async_commit();
    const bf16* st = ring + (s % kStages) * TT::STAGE;
    unsigned b[NT][2];
    load_b<NT>(b, st + kWStage, kXS, 0, lane);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < kMB; ++i) {
        unsigned a[4];
        load_a(a, st + m * kDK * kWS, 0, warp * 32 + i * 16, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) tc::mma_bf16(acc[m][i][j], a, b[j][0], b[j][1]);
      }
  }
  // h = silu(g) * u, rounded to bf16, into hT (read after the next
  // stage's barrier)
#pragma unroll
  for (int i = 0; i < kMB; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float gv = acc[0][i][j][r], uv = acc[1][i][j][r];
        const int f = warp * 32 + i * 16 + g + 8 * (r / 2);
        const int c = 8 * j + 2 * t + r % 2;
        hT[c * kWS + f] = __float2bfloat16_rn(gv / (1.f + expf(-gv)) * uv);
      }

  // down: out^T of the slice, a pass of kDP columns of D at a time, the
  // pass's kQ stages of slice rows in ascending f
  float od[kMB][NT][4];
#pragma unroll
  for (int i = 0; i < kMB; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) od[i][j][r] = 0.f;
  float* pe = part + (static_cast<long long>(e) * n_split + split) * C * D;
  for (; s < n_st; ++s) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < n_st) load(s + kStages - 1);
    tc::cp_async_commit();
    const bf16* st = ring + (s % kStages) * TT::STAGE;
    const int q = (s - n_gu) % kQ;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 16) {
      unsigned b[NT][2];
      load_b<NT>(b, hT, kWS, q * kFK + kk, lane);
#pragma unroll
      for (int i = 0; i < kMB; ++i) {
        unsigned a[4];
        load_a(a, st, kk, warp * 32 + i * 16, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) tc::mma_bf16(od[i][j], a, b[j][0], b[j][1]);
      }
    }
    if (q == kQ - 1) {  // the pass is done: store its partial, clear
      const int dp0 = (s - n_gu) / kQ * kDP;
#pragma unroll
      for (int i = 0; i < kMB; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int d = dp0 + warp * 32 + i * 16 + g + 8 * (r / 2);
            const int c = c0 + 8 * j + 2 * t + r % 2;
            if (d < D && c < C) pe[static_cast<long long>(c) * D + d] = od[i][j][r];
            od[i][j][r] = 0.f;
          }
    }
  }
  tc::cp_async_wait<0>();
  // let the reduce launch be scheduled (programmatic dependent launch); it
  // waits for this grid's completion before it reads the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// out[e, c, d] = the sum of part[e, s, c, d] over the slices s in
// ascending order, rounded once; w = 4 (D a multiple of 4) or 1 columns
// a thread.
__global__ void __launch_bounds__(256)
moe_ffn_tc_reduce(const float* __restrict__ part, bf16* __restrict__ out,
              long long n_units, int C, int D, int n_split, int w) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n_units) return;
  const long long per_row = D / w;
  const long long ec = i / per_row;
  const int d = static_cast<int>(i % per_row) * w;
  const long long e = ec / C, c = ec % C;
  const long long stride = static_cast<long long>(C) * D;
  const float* p = part + (e * n_split * C + c) * D + d;
  bf16* o = out + ec * D + d;
  if (w == 4) {
    float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    for (int k = 1; k < n_split; ++k) {
      const float4 b = __ldcs(reinterpret_cast<const float4*>(p + k * stride));
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  } else {
    float a = p[0];
    for (int k = 1; k < n_split; ++k) a += p[k * stride];
    o[0] = __float2bfloat16_rn(a);
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

template <int NT>
int launch_tc(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
              bf16* out, float* ws, int E, int C, int D, int F, int G,
              int vec, cudaStream_t st) {
  using TT = TcTile<NT>;
  static size_t configured = 48 * 1024;
  cudaError_t e = allow_smem(moe_ffn_tc_kernel<NT>, TT::SMEM, &configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (C + TT::TC - 1) / TT::TC;
  const int n_split = (F + kFS - 1) / kFS;
  moe_ffn_tc_kernel<NT><<<dim3(n_split * n_tiles, E), kTcThreads, TT::SMEM, st>>>(
      x, wg, wu, wd, ws, C, D, F, E / G, n_tiles, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int w = D % 4 == 0 ? 4 : 1;
  const long long n_units = static_cast<long long>(E) * C * (D / w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n_units + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, moe_ffn_tc_reduce, static_cast<const float*>(ws),
                         out, n_units, C, D, n_split, w);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// Dynamic shared memory of one CTA: in f32, of the one-launch kernel at
// this D; in bf16, of the tensor-core kernel at its largest token tile
// (any D).
extern "C" int moe_ffn_smem_bytes(int D, int is_bf16) {
  if (is_bf16) return TcTile<kMaxNT>::SMEM;
  const size_t n = smem_bytes(D, sizeof(float));
  return n > 0x7fffffff ? 0x7fffffff : static_cast<int>(n);
}

// The bf16 plan for C token rows and F columns, for the wrapper's
// cross-check (kernels/moe_gemm/ops.py::tc_plan mirrors it): plan[0..3] =
// F rows a slice, slices, token rows a tile, tiles.  Returns the CTA's
// dynamic shared memory.
extern "C" int moe_ffn_tc_plan(int C, int F, int* plan) {
  if (C <= 0 || F <= 0) return -1;
  const int nt = tc_blocks(C);
  plan[0] = kFS;
  plan[1] = (F + kFS - 1) / kFS;
  plan[2] = 8 * nt;
  plan[3] = (C + 8 * nt - 1) / (8 * nt);
  switch (nt) {
    case 1: return TcTile<1>::SMEM;
    case 2: return TcTile<2>::SMEM;
    case 3: return TcTile<3>::SMEM;
    case 4: return TcTile<4>::SMEM;
    default: return TcTile<5>::SMEM;
  }
}

// f32 (CUDA cores).  x (G, C, D); wg/wu (E, D, F); wd (E, F, D); out (E,
// C, D).  All contiguous; vec: D and F multiples of 8 and every pointer
// 16-byte aligned.  dt: D (one launch) or a multiple of 2048 below D (the
// two launches), with h an f32 (E, C, F) scratch.
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* out, void* h, int E,
                              int C, int D, int F, int G, int dt, int vec,
                              void* stream) {
  return vec ? launch<float, true>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                   stream)
             : launch<float, false>(x, wg, wu, wd, out, h, E, C, D, F, G, dt,
                                    stream);
}

// bf16 (tensor cores, two launches).  Operands as above; ws: the f32
// partials (E, ceil(F / 256), C, D); vec as above.
extern "C" int moe_ffn_tc_launch(const void* x, const void* wg,
                                 const void* wu, const void* wd, void* out,
                                 void* ws, int E, int C, int D, int F, int G,
                                 int vec, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || G <= 0 || E % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *xp = static_cast<const bf16*>(x),
             *gp = static_cast<const bf16*>(wg),
             *up = static_cast<const bf16*>(wu),
             *dp = static_cast<const bf16*>(wd);
  bf16* op = static_cast<bf16*>(out);
  float* wp = static_cast<float*>(ws);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc_blocks(C)) {
    case 1: return launch_tc<1>(xp, gp, up, dp, op, wp, E, C, D, F, G, vec, st);
    case 2: return launch_tc<2>(xp, gp, up, dp, op, wp, E, C, D, F, G, vec, st);
    case 3: return launch_tc<3>(xp, gp, up, dp, op, wp, E, C, D, F, G, vec, st);
    case 4: return launch_tc<4>(xp, gp, up, dp, op, wp, E, C, D, F, G, vec, st);
    default: return launch_tc<5>(xp, gp, up, dp, op, wp, E, C, D, F, G, vec, st);
  }
}
