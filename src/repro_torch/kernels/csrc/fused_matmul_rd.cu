// Row-parallel GEMM fused with the recursive-doubling all-reduce over the
// slow axis of a virtual mesh, for Hopper (sm_90a): the paper's chunked,
// non-blocking communication (Sec. 4.2.1) applied at the producer.
//
// Replaces the TPU kernel src/repro/kernels/rd_allreduce/fused_matmul.py
// _fused_kernel (fused_matmul_rd_call), which computes column block c on
// the MXU, starts that block's step-0 remote DMA and computes block c+1
// while block c is on the wire.
//
// What it computes.  x is (R, M, K) and w is (R, K, N), one slice per rank
// of a (pods, fast) mesh, rank = pod * fast + f.  Rank (p, f) gets
//   sum over p' of round(x[p', f] @ w[p', f])
// in out (R, M, N): the GEMM accumulates in f32 with one rounding to the
// operand type, then log2(pods) XOR-peer steps each add the peer's
// current partial in f32 with one rounding (kernel 4's adds, so every
// rank of a fast column ends bitwise equal).  The sum over the fast ranks
// is left to the caller, as in the TPU kernel.
//
// The GEMM, f32.  Written out here, no library: a CTA of 256 threads
// computes a BM x BN tile with a k loop over BK-deep slices staged through
// shared memory as f32 (global loads of the next slice are issued before
// the current one is multiplied), each thread TM x TN outputs with
// explicit f32 FMAs in ascending k, so f32 operands stay exact (no TF32).
// Two configs: BM = 16 for the decode rows (M <= 16), BM = 64 above.
//
// The GEMM, bf16, on the tensor cores (mma.sync m16n8k16, f32
// accumulators).  bf16 tiles go global -> shared by 16-byte cp.async in a
// ring of STAGES slices, without widening, and ldmatrix feeds the mma.
// Prefill rows (M > 16): 128 x 128 tiles, 8 warps of 64 x 32, BK 32, 4
// stages.  Decode rows (M <= 16): the kernel computes out^T = w^T x^T, so
// the rows are the n = 8 side of the mma (one n8 block for M <= 8, two
// for M <= 16) and no work is padded; a CTA of 4 warps owns 64 columns
// (16 a warp) and streams its w slices through 6 stages of 64 x 64, five
// in flight while one is multiplied, over 256 tiles at the path's decode
// shapes (every SM busy).  The f32 sums of the mma go in ascending k in
// 16-deep steps whatever the tile: the bf16 tile config depends on M
// only, so every output element sees one fixed sequence of operations.
// Both forms need K and N / n_chunks in multiples of 8 and 16-byte
// aligned operands; the wrapper refuses others.
//
// In every form the output is bitwise the same for every n_chunks.
//
// The exchange and the overlap.  The N columns are split into n_chunks
// blocks and every block into BN-wide tiles; a tile is (rank, row tile,
// column tile).  The grid is persistent (cooperative, sized to what is
// resident) and CTA g takes tiles g, g + grid, ... in chunk-major order.
// Pass 0: for each of its tiles it computes the GEMM, rounds, writes the
// partial to out, puts the same values into the step-0 receive buffer of
// its peer (p ^ 1, f), fences and publishes that tile's step-0 flag with
// the call's flag value, and goes on to its next tile (chunk c+1)
// while the stores drain.  Pass s + 1: for each tile it waits (acquire)
// for its own step-s flag, adds the received tile to its partial and puts
// the sum to its step-(s+1) peer.  Every CTA issues all its puts of a step
// before it waits on any flag of that step, so no CTA waits on a tile
// queued behind a waiting CTA: by induction over the steps every wait is
// met.  Per-step buffers and flags and the ~1 s trap on a wait are
// kernel 4's protocol (rd_allreduce.cu).  The flag value is an epoch in
// device memory, as kernel 4's (exchange_common.cuh): thread 0 of every
// CTA takes a ticket on word 0 of this kernel's own epoch words at the
// start and reads the epoch at its first publish, and the CTA that
// completes the grid's count moves the epoch on, so no number comes from
// the host and a captured CUDA graph replays the launch correctly.  Each
// thread adds, in every pass, exactly the elements it wrote in pass 0.
//
// What bounds it on an H100.  In decode (M = 8 rows a rank) bytes: the
// weights, R K N elements, read once, which the bf16 form streams with
// many slices in flight per SM.  In prefill operations: the bf16 form
// runs them on the tensor cores (wgmma and TMA are later work); the f32
// form on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exchange_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace exchange;
using namespace tc;

constexpr int kThreads = 256;  // threads of the f32 kernel

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static_assert((BM / TM) * (BN / TN) == kThreads,
                "one output group a thread");
};
using SmallM = Cfg<16, 64, 128, 1, 4>;  // f32 decode rows, M <= 16
using LargeM = Cfg<64, 64, 16, 4, 4>;   // f32 prefill rows
constexpr int kSmallM = 16;

struct Args {
  const void* x;
  const void* w;
  void* out;
  void* recv;
  unsigned* flags;
  int R, fast, M, K, N, chunk_w, steps;
  int row_tiles, tiles_per_chunk, tiles_per_rank;
  long long n_tiles;
  unsigned* ctl;  // this kernel's epoch words
};

template <class C>
__host__ __device__ inline int row_tiles(int M) {
  return (M + C::BM - 1) / C::BM;
}
template <class C>
__host__ __device__ inline int tiles_per_chunk(int chunk_w) {
  return (chunk_w + C::BN - 1) / C::BN;
}

struct Tile {
  int r, t_loc, row0, col0, col_end;
};

template <class C>
__device__ __forceinline__ Tile tile_of(const Args& a, long long tau) {
  Tile t;
  t.r = static_cast<int>(tau % a.R);
  t.t_loc = static_cast<int>(tau / a.R);  // chunk-major within a rank
  const int per_c = a.row_tiles * a.tiles_per_chunk;
  const int c = t.t_loc / per_c, rem = t.t_loc % per_c;
  t.row0 = (rem / a.tiles_per_chunk) * C::BM;
  t.col0 = c * a.chunk_w + (rem % a.tiles_per_chunk) * C::BN;
  t.col_end = min(t.col0 + C::BN, (c + 1) * a.chunk_w);
  return t;
}

// Global loads of one BK-deep slice: x rows [row0, row0+BM) x k, and w
// k rows x columns [col0, col_end), VEC elements a load, zeros outside.
template <typename T, class C, int VEC>
struct Slice {
  using P = Pack<T, VEC>;
  static constexpr int XU = (C::BM * C::BK / VEC + kThreads - 1) / kThreads;
  static constexpr int WU = (C::BK * C::BN / VEC + kThreads - 1) / kThreads;
  P xr[XU], wr[WU];

  __device__ __forceinline__ void load(const T* x, const T* w, const Args& a,
                                       const Tile& t, int k0) {
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int row = idx / (C::BK / VEC), kv = (idx % (C::BK / VEC)) * VEC;
      const int m = t.row0 + row, k = k0 + kv;
      if (idx < C::BM * C::BK / VEC && m < a.M && k < a.K) {
        xr[u] = *reinterpret_cast<const P*>(
            x + (static_cast<long long>(t.r) * a.M + m) * a.K + k);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xr[u].v[e] = from_f<T>(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int krow = idx / (C::BN / VEC), nv = (idx % (C::BN / VEC)) * VEC;
      const int k = k0 + krow, n = t.col0 + nv;
      if (idx < C::BK * C::BN / VEC && k < a.K && n < t.col_end) {
        wr[u] = *reinterpret_cast<const P*>(
            w + (static_cast<long long>(t.r) * a.K + k) * a.N + n);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) wr[u].v[e] = from_f<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(float (*xs)[C::BM],
                                        float (*ws)[C::BN]) const {
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx >= C::BM * C::BK / VEC) break;
      const int row = idx / (C::BK / VEC), kv = (idx % (C::BK / VEC)) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[kv + e][row] = to_f(xr[u].v[e]);
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx >= C::BK * C::BN / VEC) break;
      const int krow = idx / (C::BN / VEC), nv = (idx % (C::BN / VEC)) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) ws[krow][nv + e] = to_f(wr[u].v[e]);
    }
  }
};

// acc[i][j] = sum over k ascending of x[row0 + ty*TM + i, k] *
// w[k, col0 + tx*TN + j], one fmaf per k.
template <typename T, class C, int VEC>
__device__ __forceinline__ void gemm_tile(const T* x, const T* w,
                                          const Args& a, const Tile& t,
                                          float (*xs)[C::BM],
                                          float (*ws)[C::BN],
                                          float (&acc)[C::TM][C::TN]) {
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  Slice<T, C, VEC> sl;
  sl.load(x, w, a, t, 0);
  for (int k0 = 0; k0 < a.K; k0 += C::BK) {
    sl.store(xs, ws);
    __syncthreads();
    if (k0 + C::BK < a.K) sl.load(x, w, a, t, k0 + C::BK);
#pragma unroll 8
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[C::TM], bv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) av[i] = xs[kk][ty * C::TM + i];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) bv[j] = ws[kk][tx * C::TN + j];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int peer_of(int r, int fast, int s) {
  return ((r / fast) ^ (1 << s)) * fast + r % fast;
}

__device__ __forceinline__ unsigned* flag_of(const Args& a, int s, int rank,
                                             int t_loc) {
  return a.flags + (static_cast<long long>(s) * a.R + rank) * a.tiles_per_rank
         + t_loc;
}

// The TN outputs of one thread's row i of a tile: a Pack of TN elements
// when VEC > 1 (N, the chunk width and the tile's columns are then
// multiples of VEC >= TN), else one element at a time.
template <typename T, class C, int VEC>
struct Row {
  static constexpr int E = VEC > 1 ? C::TN : 1;
  using P = Pack<T, E>;
};

// Two CTAs an SM at least (<= 128 registers a thread): the decode grid
// of 256 tiles then stays resident in one wave.
template <typename T, class C, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_matmul_rd_kernel(const Args a) {
  __shared__ __align__(16) float xs[C::BK][C::BM];
  __shared__ __align__(16) float ws[C::BK][C::BN];
  using RowT = Row<T, C, VEC>;
  using P = typename RowT::P;
  constexpr int E = RowT::E;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  T* out = static_cast<T*>(a.out);
  T* recv = static_cast<T*>(a.recv);
  const long long MN = static_cast<long long>(a.M) * a.N;
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
  // thread 0 alone publishes and waits, so it alone holds the flag value
  unsigned long long ticket = 0;
  unsigned seq = 0;
  if (a.steps && threadIdx.x == 0) ticket = grid_epoch_ticket(a.ctl);

  // Pass 0: the GEMM of every tile in chunk order, each put to its step-0
  // peer as soon as it is computed.
  for (long long tau = blockIdx.x; tau < a.n_tiles; tau += gridDim.x) {
    const Tile t = tile_of<C>(a, tau);
    float acc[C::TM][C::TN];
    gemm_tile<T, C, VEC>(x, w, a, t, xs, ws, acc);
    const int peer = a.steps ? peer_of(t.r, a.fast, 0) : 0;
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int m = t.row0 + ty * C::TM + i;
#pragma unroll
      for (int j0 = 0; j0 < C::TN; j0 += E) {
        const int n = t.col0 + tx * C::TN + j0;
        if (m >= a.M || n >= t.col_end) continue;
        P v;
#pragma unroll
        for (int e = 0; e < E; ++e) v.v[e] = from_f<T>(acc[i][j0 + e]);
        const long long o = static_cast<long long>(m) * a.N + n;
        *reinterpret_cast<P*>(out + t.r * MN + o) = v;
        if (a.steps)
          store_cg(reinterpret_cast<P*>(
                       recv + static_cast<long long>(peer) * MN + o), v);
      }
    }
    if (a.steps) {
      if (threadIdx.x == 0 && !seq) seq = grid_epoch_value(a.ctl, ticket);
      publish(flag_of(a, 0, peer, t.t_loc), seq);
    }
  }

  // Passes 1..steps: add the step-s tile from the peer, put the sum on.
  for (int s = 0; s < a.steps; ++s) {
    const T* mine = recv + static_cast<long long>(s) * a.R * MN;
    const bool more = s + 1 < a.steps;
    for (long long tau = blockIdx.x; tau < a.n_tiles; tau += gridDim.x) {
      const Tile t = tile_of<C>(a, tau);
      const int next = more ? peer_of(t.r, a.fast, s + 1) : 0;
      T* to_next = recv + (static_cast<long long>(s + 1) * a.R + next) * MN;
      cta_wait(flag_of(a, s, t.r, t.t_loc), seq);
      // each thread adds the elements it wrote, so out is only ever read
      // by the thread that wrote it
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const int m = t.row0 + ty * C::TM + i;
#pragma unroll
        for (int j0 = 0; j0 < C::TN; j0 += E) {
          const int n = t.col0 + tx * C::TN + j0;
          if (m >= a.M || n >= t.col_end) continue;
          const long long o = static_cast<long long>(m) * a.N + n;
          P* dst = reinterpret_cast<P*>(out + t.r * MN + o);
          const P v = add(*dst, load_cg(reinterpret_cast<const P*>(
                                    mine + t.r * MN + o)));
          *dst = v;
          if (more) store_cg(reinterpret_cast<P*>(to_next + o), v);
        }
      }
      if (more) publish(flag_of(a, s + 1, next, t.t_loc), seq);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A tile config of the bf16 kernel: a BM x BN output tile, BK-deep slices
// in a ring of STAGES, WM x WN warps.  SWAP: the decode form, out^T =
// w^T x^T, with a warp's 16 columns the m side and the BM rows the n side.
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_,
          bool SWAP_>
struct TcCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, THREADS = 32 * WM_ * WN_;
  static constexpr bool SWAP = SWAP_;
  // m16 and n8 blocks of a warp's accumulator
  static constexpr int MI = SWAP ? 1 : BM / WM / 16;
  static constexpr int NI = SWAP ? BM / 8 : BN / WN / 8;
  // row strides in shared memory, padded by 16 bytes: the 8 rows of an
  // ldmatrix fall on distinct banks
  static constexpr int XS = BK + 8, WS = BN + 8, OS = BN + 8;
  static constexpr int STAGE = BM * XS + BK * WS;  // elements a slice
  static constexpr int SMEM =
      2 * (STAGES * STAGE > BM * OS ? STAGES * STAGE : BM * OS);
  static_assert(!SWAP || (WM == 1 && BN == 16 * WN && BM % 8 == 0 &&
                          BM <= 16),
                "decode form: 16 columns a warp, at most 16 rows");
  static_assert(SWAP || (MI * 16 * WM == BM && NI * 8 * WN == BN &&
                         NI % 2 == 0),
                "prefill form: whole m16 and pairs of n8 blocks a warp");
};
using TcPrefill = TcCfg<128, 128, 32, 4, 2, 4, false>;
template <int MN>
using TcDecode = TcCfg<8 * MN, 64, 64, 6, 1, 4, true>;

// Issue the cp.async copies of one BK-deep slice: x rows [row0, row0+BM)
// x k and w k rows x columns [col0, col_end), 16 bytes a copy, zeros
// outside (K, N / n_chunks multiples of 8: a copy is all in or all out).
template <class C>
__device__ __forceinline__ void tc_load(bf16* st, const bf16* x,
                                        const bf16* w, const Args& a,
                                        const Tile& t, int k0) {
  bf16* xs = st;
  bf16* ws = st + C::BM * C::XS;
  constexpr int XC = C::BM * C::BK / 8, WC = C::BK * C::BN / 8;
#pragma unroll
  for (int u = 0; u < (XC + C::THREADS - 1) / C::THREADS; ++u) {
    const int i = threadIdx.x + u * C::THREADS;
    if (XC % C::THREADS && i >= XC) break;
    const int row = i / (C::BK / 8), kc = (i % (C::BK / 8)) * 8;
    const int m = t.row0 + row, k = k0 + kc;
    const bool ok = m < a.M && k < a.K;
    cp_async16(xs + row * C::XS + kc,
               ok ? x + (static_cast<long long>(t.r) * a.M + m) * a.K + k
                  : x,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int u = 0; u < (WC + C::THREADS - 1) / C::THREADS; ++u) {
    const int i = threadIdx.x + u * C::THREADS;
    if (WC % C::THREADS && i >= WC) break;
    const int kr = i / (C::BN / 8), nc = (i % (C::BN / 8)) * 8;
    const int k = k0 + kr, n = t.col0 + nc;
    const bool ok = k < a.K && n < t.col_end;
    cp_async16(ws + kr * C::WS + nc,
               ok ? w + (static_cast<long long>(t.r) * a.K + k) * a.N + n
                  : w,
               ok ? 16 : 0);
  }
}

// acc = the tile's x @ w in f32: slices in ascending k, 16-deep mma steps
// in ascending k within a slice.
template <class C>
__device__ __forceinline__ void tc_gemm(const bf16* x, const bf16* w,
                                        const Args& a, const Tile& t,
                                        bf16* smem,
                                        float (&acc)[C::MI][C::NI][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int KT = (a.K + C::BK - 1) / C::BK;
  __syncthreads();  // the previous tile's staged output has been read
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) tc_load<C>(smem + s * C::STAGE, x, w, a, t, s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's slot is free
    const int nk = kt + C::STAGES - 1;
    if (nk < KT)
      tc_load<C>(smem + (nk % C::STAGES) * C::STAGE, x, w, a, t,
                 nk * C::BK);
    cp_async_commit();
    const bf16* xs = smem + (kt % C::STAGES) * C::STAGE;
    const bf16* ws = xs + C::BM * C::XS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      if constexpr (C::SWAP) {
        // A = w^T (16 columns x 16 k) from w's k-major rows, transposed
        unsigned af[4];
        ldmatrix_x4_trans(af, ws + (kk + (lane & 7) + ((lane >> 4) & 1) * 8)
                                       * C::WS
                                  + wn * 16 + ((lane >> 3) & 1) * 8);
        // B = x^T (16 k x 8 rows): x's rows as they are
        if constexpr (C::NI == 1) {
          unsigned b[2];
          ldmatrix_x2(b, xs + (lane & 7) * C::XS + kk +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(acc[0][0], af, b[0], b[1]);
        } else {
          unsigned b[4];
          ldmatrix_x4(b, xs + ((lane & 7) + (lane >> 4) * 8) * C::XS + kk +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(acc[0][0], af, b[0], b[1]);
          mma_bf16(acc[0][1], af, b[2], b[3]);
        }
      } else {
        unsigned af[C::MI][4];
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
          ldmatrix_x4(af[i], xs + (wm * (C::BM / C::WM) + i * 16 +
                                   (lane & 15)) * C::XS +
                                 kk + (lane >> 4) * 8);
        unsigned bq[C::NI][2];
#pragma unroll
        for (int j2 = 0; j2 < C::NI / 2; ++j2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, ws + (kk + (lane & 15)) * C::WS +
                                   wn * (C::BN / C::WN) + j2 * 16 +
                                   (lane >> 4) * 8);
          bq[2 * j2][0] = r[0];
          bq[2 * j2][1] = r[1];
          bq[2 * j2 + 1][0] = r[2];
          bq[2 * j2 + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
#pragma unroll
          for (int j = 0; j < C::NI; ++j)
            mma_bf16(acc[i][j], af[i], bq[j][0], bq[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
}

// Round the tile's accumulators to bf16 into shared memory as the
// (BM, BN) output tile (row stride OS), for 16-byte stores.
template <class C>
__device__ __forceinline__ void tc_stage(bf16* os,
                                         const float (&acc)[C::MI][C::NI][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  if constexpr (C::SWAP) {
    const int col = wn * 16 + g;
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      const int row = j * 8 + 2 * tq;
      os[row * C::OS + col] = __float2bfloat16_rn(acc[0][j][0]);
      os[(row + 1) * C::OS + col] = __float2bfloat16_rn(acc[0][j][1]);
      os[row * C::OS + col + 8] = __float2bfloat16_rn(acc[0][j][2]);
      os[(row + 1) * C::OS + col + 8] = __float2bfloat16_rn(acc[0][j][3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        const int row = wm * (C::BM / C::WM) + i * 16 + g;
        const int col = wn * (C::BN / C::WN) + j * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(os + row * C::OS + col) =
            pack_bf16(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<unsigned*>(os + (row + 8) * C::OS + col) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();
}

// The bf16 kernel: the passes of the f32 kernel over 16-byte pieces of a
// tile, piece i of a tile always the thread i mod THREADS's, with one
// change that saves two of the nine passes over R M N elements that two
// steps take: a partial goes only to the peer's receive buffer (the rank
// reads its own back from there in the next pass, as the peer does) and
// out is written once, by the last pass.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
fused_matmul_rd_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  using P = Pack<bf16, 8>;
  constexpr int CPR = C::BN / 8;  // pieces of a tile row
  constexpr int PIECES = C::BM * CPR;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  bf16* out = static_cast<bf16*>(a.out);
  bf16* recv = static_cast<bf16*>(a.recv);
  const long long MN = static_cast<long long>(a.M) * a.N;
  unsigned long long ticket = 0;  // thread 0's, as in the f32 kernel
  unsigned seq = 0;
  if (a.steps && threadIdx.x == 0) ticket = grid_epoch_ticket(a.ctl);

  for (long long tau = blockIdx.x; tau < a.n_tiles; tau += gridDim.x) {
    const Tile t = tile_of<C>(a, tau);
    float acc[C::MI][C::NI][4];
    tc_gemm<C>(x, w, a, t, smem, acc);
    tc_stage<C>(smem, acc);
    const int peer = a.steps ? peer_of(t.r, a.fast, 0) : 0;
    bf16* dst = a.steps ? recv + static_cast<long long>(peer) * MN
                        : out + t.r * MN;
    for (int i = threadIdx.x; i < PIECES; i += C::THREADS) {
      const int m = t.row0 + i / CPR, n = t.col0 + (i % CPR) * 8;
      if (m >= a.M || n >= t.col_end) continue;
      const P v = *reinterpret_cast<const P*>(smem + (i / CPR) * C::OS +
                                              (i % CPR) * 8);
      store_cg(reinterpret_cast<P*>(dst + static_cast<long long>(m) * a.N + n),
               v);
    }
    if (a.steps) {
      if (threadIdx.x == 0 && !seq) seq = grid_epoch_value(a.ctl, ticket);
      publish(flag_of(a, 0, peer, t.t_loc), seq);
    }
  }

  // Pass s + 1: this rank's partial is the one it put to its step-s peer
  // (read back, as the peer reads it), the peer's is in its own slot.
  for (int s = 0; s < a.steps; ++s) {
    const bf16* buf = recv + static_cast<long long>(s) * a.R * MN;
    const bool more = s + 1 < a.steps;
    for (long long tau = blockIdx.x; tau < a.n_tiles; tau += gridDim.x) {
      const Tile t = tile_of<C>(a, tau);
      const bf16* mine = buf + static_cast<long long>(
                                   peer_of(t.r, a.fast, s)) * MN;
      const bf16* theirs = buf + t.r * MN;
      const int next = more ? peer_of(t.r, a.fast, s + 1) : 0;
      bf16* dst = more ? recv + (static_cast<long long>(s + 1) * a.R + next)
                                    * MN
                       : out + t.r * MN;
      cta_wait(flag_of(a, s, t.r, t.t_loc), seq);
      for (int i = threadIdx.x; i < PIECES; i += C::THREADS) {
        const int m = t.row0 + i / CPR, n = t.col0 + (i % CPR) * 8;
        if (m >= a.M || n >= t.col_end) continue;
        const long long o = static_cast<long long>(m) * a.N + n;
        const P v = add(load_cg(reinterpret_cast<const P*>(mine + o)),
                        load_cg(reinterpret_cast<const P*>(theirs + o)));
        store_cg(reinterpret_cast<P*>(dst + o), v);
      }
      if (more) publish(flag_of(a, s + 1, next, t.t_loc), seq);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <class C>
bool plan(int M, int N, int n_chunks, int* tiles_per_rank) {
  if (M <= 0 || N <= 0 || n_chunks <= 0 || N % n_chunks) return false;
  *tiles_per_rank =
      n_chunks * row_tiles<C>(M) * tiles_per_chunk<C>(N / n_chunks);
  return true;
}

// Fill the kernel arguments of config C; false when the call is refused.
// vec: elements of a 16-byte vector that K and N / n_chunks must be
// multiples of (1: no constraint).
template <class C>
bool make_args(Args& a, const void* x, const void* w, void* out, void* recv,
               void* flags, void* ctl, long long n_flags, int R, int pods,
               int M, int K, int N, int n_chunks, int grid, int vec) {
  int tiles = 0;
  if (R <= 0 || pods <= 0 || R % pods || (pods & (pods - 1)) || K <= 0 ||
      !plan<C>(M, N, n_chunks, &tiles))
    return false;
  a.x = x;
  a.w = w;
  a.out = out;
  a.recv = recv;
  a.flags = static_cast<unsigned*>(flags);
  a.R = R;
  a.fast = R / pods;
  a.M = M;
  a.K = K;
  a.N = N;
  a.chunk_w = N / n_chunks;
  a.steps = 0;
  while ((1 << a.steps) < pods) ++a.steps;
  a.row_tiles = row_tiles<C>(M);
  a.tiles_per_chunk = tiles_per_chunk<C>(a.chunk_w);
  a.tiles_per_rank = tiles;
  a.n_tiles = static_cast<long long>(R) * tiles;
  a.ctl = static_cast<unsigned*>(ctl);
  return !((vec > 1 && (K % vec || a.chunk_w % vec)) || grid <= 0 ||
           grid > a.n_tiles ||
           static_cast<long long>(a.steps) * R * tiles > n_flags);
}

template <typename T, class C, int VEC>
int launch(const void* x, const void* w, void* out, void* recv, void* flags,
           void* ctl, long long n_flags, int R, int pods, int M, int K, int N,
           int n_chunks, int grid, void* stream) {
  Args a;
  if (!make_args<C>(a, x, w, out, recv, flags, ctl, n_flags, R, pods, M, K,
                    N, n_chunks, grid, VEC))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_matmul_rd_kernel<T, C, VEC>), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's dynamic shared memory is above the 48 KB default.
template <class C>
cudaError_t tc_configure() {
  static bool done = false;  // per config
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_matmul_rd_tc_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  done = e == cudaSuccess;
  return e;
}

template <class C>
int launch_tc(const void* x, const void* w, void* out, void* recv,
              void* flags, void* ctl, long long n_flags, int R, int pods,
              int M, int K, int N, int n_chunks, int grid, void* stream) {
  Args a;
  if (!make_args<C>(a, x, w, out, recv, flags, ctl, n_flags, R, pods, M, K,
                    N, n_chunks, grid, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = tc_configure<C>();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_matmul_rd_tc_kernel<C>), dim3(grid),
      dim3(C::THREADS), args, C::SMEM, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

cudaError_t resident(const void* kern, int threads, int smem, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  *n = sms * per_sm;
  return e;
}

template <typename T, class C, int VEC>
int max_ctas() {
  int n = 0;
  const cudaError_t e = resident(
      reinterpret_cast<const void*>(fused_matmul_rd_kernel<T, C, VEC>),
      kThreads, 0, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <class C>
int max_ctas_tc() {
  cudaError_t e = tc_configure<C>();
  int n = 0;
  if (e == cudaSuccess)
    e = resident(reinterpret_cast<const void*>(fused_matmul_rd_tc_kernel<C>),
                 C::THREADS, C::SMEM, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The one dispatch over (type, vector width, tile config), for the
// launch, the occupancy query and the tile count: f.go<T, C, VEC>() for
// f32, f.go_tc<C>() for bf16, which takes 16-byte vectors only (-1, which
// is also minus cudaErrorInvalidValue, without them).
template <class F>
int dispatch(int is_bf16, int vec, int M, F& f) {
  if (is_bf16) {
    if (!vec) return -1;
    if (M <= 8) return f.template go_tc<TcDecode<1>>();
    if (M <= kSmallM) return f.template go_tc<TcDecode<2>>();
    return f.template go_tc<TcPrefill>();
  }
  const bool small = M <= kSmallM;
  if (vec) return small ? f.template go<float, SmallM, 4>()
                        : f.template go<float, LargeM, 4>();
  return small ? f.template go<float, SmallM, 1>()
               : f.template go<float, LargeM, 1>();
}

struct Launch {
  const void *x, *w;
  void *out, *recv, *flags, *ctl;
  long long n_flags;
  int R, pods, M, K, N, n_chunks, grid;
  void* stream;
  template <typename T, class C, int VEC>
  int go() {
    return launch<T, C, VEC>(x, w, out, recv, flags, ctl, n_flags, R, pods,
                             M, K, N, n_chunks, grid, stream);
  }
  template <class C>
  int go_tc() {
    return launch_tc<C>(x, w, out, recv, flags, ctl, n_flags, R, pods, M, K,
                        N, n_chunks, grid, stream);
  }
};

struct MaxCtas {
  template <typename T, class C, int VEC>
  int go() { return max_ctas<T, C, VEC>(); }
  template <class C>
  int go_tc() { return max_ctas_tc<C>(); }
};

struct Tiles {
  int M, N, n_chunks;
  template <class C>
  int count() {
    int tiles = 0;
    return plan<C>(M, N, n_chunks, &tiles) ? tiles : -1;
  }
  template <typename T, class C, int VEC>
  int go() { return count<C>(); }
  template <class C>
  int go_tc() { return count<C>(); }
};

}  // namespace

// x (R, M, K), w (R, K, N), out (R, M, N): contiguous f32 (or bf16 when
// is_bf16); vec: K, N and N / n_chunks are multiples of 16 bytes' worth of
// elements and the pointers 16-byte aligned (bf16 requires it).  recv:
// (steps, R, M, N) of the same type; flags: n_flags uint32 >= steps * R *
// tiles_per_rank, zero at first use; ctl: this kernel's epoch words
// (uint32 [8][32], word 0's epoch starting at 1).  `grid` CTAs (at most
// the resident count and the tile count), launched cooperatively on
// `stream`.
extern "C" int fused_matmul_rd_launch(const void* x, const void* w, void* out,
                                      void* recv, void* flags, void* ctl,
                                      long long n_flags, int R, int pods,
                                      int M, int K, int N, int n_chunks,
                                      int grid, int is_bf16, int vec,
                                      void* stream) {
  Launch l{x, w, out, recv, flags, ctl, n_flags, R, pods, M, K, N, n_chunks,
           grid, stream};
  const int err = dispatch(is_bf16, vec, M, l);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

// Tiles a rank of the call has (the flags it needs a step), or -1 when the
// shape is refused (N not divisible by n_chunks, or bf16 without vec).
extern "C" int fused_matmul_rd_tiles(int M, int N, int n_chunks, int is_bf16,
                                     int vec) {
  Tiles q{M, N, n_chunks};
  return dispatch(is_bf16, vec, M, q);
}

// CTAs of one launch for M rows that the card holds resident at once, or
// minus a CUDA error code.
extern "C" int fused_matmul_rd_max_ctas(int is_bf16, int vec, int M) {
  MaxCtas q;
  return dispatch(is_bf16, vec, M, q);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
