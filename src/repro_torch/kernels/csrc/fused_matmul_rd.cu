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
// The GEMM.  Written out here, no library: a CTA of 256 threads computes a
// BM x BN tile with a k loop over BK-deep slices staged through shared
// memory as f32 (global loads of the next slice are issued before the
// current one is multiplied), each thread TM x TN outputs with explicit
// f32 FMAs in ascending k.  Every output element therefore sees one fixed
// sequence of FMAs, whatever the tile config or the column blocks, so the
// output is bitwise the same for every n_chunks.  Two configs: BM = 16 for
// the decode rows (M <= 16), BM = 64 above.
//
// The exchange and the overlap.  The N columns are split into n_chunks
// blocks and every block into BN-wide tiles; a tile is (rank, row tile,
// column tile).  The grid is persistent (cooperative, sized to what is
// resident) and CTA g takes tiles g, g + grid, ... in chunk-major order.
// Pass 0: for each of its tiles it computes the GEMM, rounds, writes the
// partial to out, puts the same values into the step-0 receive buffer of
// its peer (p ^ 1, f), fences and publishes that tile's step-0 flag with
// the call's sequence number, and goes on to its next tile (chunk c+1)
// while the stores drain.  Pass s + 1: for each tile it waits (acquire)
// for its own step-s flag, adds the received tile to its partial and puts
// the sum to its step-(s+1) peer.  Every CTA issues all its puts of a step
// before it waits on any flag of that step, so no CTA waits on a tile
// queued behind a waiting CTA: by induction over the steps every wait is
// met.  Per-step buffers and flags, the sequence numbers and the ~1 s
// trap on a wait are kernel 4's protocol (rd_allreduce.cu).
//
// What bounds it on an H100.  In decode (M = 8 rows a rank) bytes: the
// weights, R K N elements, read once; the kernel streams them through
// 16-byte loads with one slice in flight per CTA.  In prefill operations:
// f32 FMAs on the CUDA cores (not the tensor cores), which is the simple
// right kernel; tensor-core mma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exchange_common.cuh"

namespace {

using namespace exchange;

constexpr int kThreads = 256;  // THREADS in fused_matmul_rd/ops.py

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static_assert((BM / TM) * (BN / TN) == kThreads,
                "one output group a thread");
};
using SmallM = Cfg<16, 64, 128, 1, 4>;  // decode rows, M <= 16
using LargeM = Cfg<64, 64, 16, 4, 4>;   // prefill rows
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
  unsigned seq;
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
    if (a.steps) publish(flag_of(a, 0, peer, t.t_loc), a.seq);
  }

  // Passes 1..steps: add the step-s tile from the peer, put the sum on.
  for (int s = 0; s < a.steps; ++s) {
    const T* mine = recv + static_cast<long long>(s) * a.R * MN;
    const bool more = s + 1 < a.steps;
    for (long long tau = blockIdx.x; tau < a.n_tiles; tau += gridDim.x) {
      const Tile t = tile_of<C>(a, tau);
      const int next = more ? peer_of(t.r, a.fast, s + 1) : 0;
      T* to_next = recv + (static_cast<long long>(s + 1) * a.R + next) * MN;
      cta_wait(flag_of(a, s, t.r, t.t_loc), a.seq);
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
      if (more) publish(flag_of(a, s + 1, next, t.t_loc), a.seq);
    }
  }
}

template <class C>
bool plan(int M, int N, int n_chunks, int* tiles_per_rank) {
  if (M <= 0 || N <= 0 || n_chunks <= 0 || N % n_chunks) return false;
  *tiles_per_rank =
      n_chunks * row_tiles<C>(M) * tiles_per_chunk<C>(N / n_chunks);
  return true;
}

template <typename T, class C, int VEC>
int launch(const void* x, const void* w, void* out, void* recv, void* flags,
           long long n_flags, int R, int pods, int M, int K, int N,
           int n_chunks, int grid, unsigned seq, void* stream) {
  Args a;
  int tiles = 0;
  if (R <= 0 || pods <= 0 || R % pods || (pods & (pods - 1)) || K <= 0 ||
      !plan<C>(M, N, n_chunks, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.seq = seq;
  if ((VEC > 1 && (K % VEC || a.chunk_w % VEC)) || grid <= 0 ||
      grid > a.n_tiles ||
      static_cast<long long>(a.steps) * R * tiles > n_flags)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_matmul_rd_kernel<T, C, VEC>), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class C, int VEC>
int max_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_matmul_rd_kernel<T, C, VEC>, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per_sm;
}

// The one dispatch over (type, vector width, tile config), for both the
// launch and the occupancy query: f.go<T, C, VEC>().
template <class F>
int dispatch(int is_bf16, int vec, int M, F& f) {
  using bf = __nv_bfloat16;
  const bool small = M <= kSmallM;
  if (is_bf16) {
    if (vec) return small ? f.template go<bf, SmallM, 8>()
                          : f.template go<bf, LargeM, 8>();
    return small ? f.template go<bf, SmallM, 1>()
                 : f.template go<bf, LargeM, 1>();
  }
  if (vec) return small ? f.template go<float, SmallM, 4>()
                        : f.template go<float, LargeM, 4>();
  return small ? f.template go<float, SmallM, 1>()
               : f.template go<float, LargeM, 1>();
}

struct Launch {
  const void *x, *w;
  void *out, *recv, *flags;
  long long n_flags;
  int R, pods, M, K, N, n_chunks, grid;
  unsigned seq;
  void* stream;
  template <typename T, class C, int VEC>
  int go() {
    return launch<T, C, VEC>(x, w, out, recv, flags, n_flags, R, pods, M, K,
                             N, n_chunks, grid, seq, stream);
  }
};

struct MaxCtas {
  template <typename T, class C, int VEC>
  int go() { return max_ctas<T, C, VEC>(); }
};

}  // namespace

// x (R, M, K), w (R, K, N), out (R, M, N): contiguous f32 (or bf16 when
// is_bf16); vec: K, N and N / n_chunks are multiples of 16 bytes' worth of
// elements and the pointers 16-byte aligned.  recv: (steps, R, M, N) of
// the same type; flags: n_flags uint32 >= steps * R * tiles_per_rank, zero
// at first use.  `grid` CTAs (at most the resident count and the tile
// count), launched cooperatively on `stream`.
extern "C" int fused_matmul_rd_launch(const void* x, const void* w, void* out,
                                      void* recv, void* flags,
                                      long long n_flags, int R, int pods,
                                      int M, int K, int N, int n_chunks,
                                      int grid, unsigned seq, int is_bf16,
                                      int vec, void* stream) {
  Launch l{x, w, out, recv, flags, n_flags, R, pods, M, K, N, n_chunks,
           grid, seq, stream};
  return dispatch(is_bf16, vec, M, l);
}

// Tiles a rank of the call has (the flags it needs a step), or -1 when the
// shape is refused (N not divisible by n_chunks).
extern "C" int fused_matmul_rd_tiles(int M, int N, int n_chunks) {
  int tiles = 0;
  const bool ok = M <= kSmallM ? plan<SmallM>(M, N, n_chunks, &tiles)
                               : plan<LargeM>(M, N, n_chunks, &tiles);
  return ok ? tiles : -1;
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
