// Quantized recursive-doubling all-reduce over one axis of a virtual mesh,
// for Hopper (sm_90a): the slow phase of ar_quant = int8 | int4 under
// hier_rd and hier_rd_halving, pack, exchange and unpack of every step in
// one launch on the LL packets of the recursive-doubling kernel
// (rd_allreduce.cu).
//
// Replaces the slow phase's use of the TPU kernels
// src/repro/kernels/rd_allreduce/quant_kernel.py _quantize_kernel and
// _dequant_kernel, which the reference's core/hierarchical.py::
// quant_rd_all_reduce calls around its ppermutes at every step.
//
// What it computes.  x is (R, m), one row per rank, the axis of size n =
// 2^k at stride `inner` in the rank index (rank r's index on the axis is
// (r / inner) % n).  At step s = 0..k-1 every rank r and its peer (index
// i ^ 2^s on the axis) compute
//   acc <- deq(Q(acc)) + deq(Q(acc_peer))
// with Q the group quantization at the cap (int8 group 128, int4 group 64)
// over the row padded with zeros to a multiple of 256, and deq with the
// bf16 stored scale: own term first, each product and the sum in f32 (the
// _rn intrinsics: no fused multiply-add).  Both peers of a step hold the
// same pair, f32 addition is commutative, so every rank ends bitwise
// identical, and bitwise equal to the plain loop (quant_rd_allreduce/
// ref.py).  The row is read unpadded: the tail up to the 256 multiple is
// zeros in registers (zeros quantize exactly), and only m elements are
// written, in x's type.
//
// What bounds it on an H100.  At the decode message (8192 f32 a rank on
// 4 x 2 ranks) latency: k round trips between SMs through L2, the launch
// and its tail.  At the prefill message (4 M f32 a rank) bytes: x read and
// out written once, plus the packets of every step (1.02 or 0.53 byte an
// element, doubled by the LL flag words) through L2 and HBM.
//
// Layout of the work.  One warp a tile of 256 elements, each lane a run of
// 4 adjacent ones in each half-tile (quant_common.cuh), in f32 registers
// across all steps; a group is a half-tile's 32 lanes (int8 g128) or 16
// lanes (int4 g64), its absmax reduced with xor shuffles.  A step's
// packets carry the packed payload, never dequantized f32: a lane's 8
// values are 2 int8 packets or 1 int4 packet (4 payload bytes each, beside
// the call's epoch, one 8-byte relaxed store), and a tile's bf16 scales
// travel two to a packet (int8: 1 packet a tile, int4: 2), so the wire
// carries exactly the reference's bytes.  The packets of a rank
// and step are a row of the receive buffer: the tiles' data packets, then
// their scale packets.  The receiver polls its own packets with 64-bit
// loads until they carry the epoch (exchange_common.cuh): no fence, no
// barrier and no flag word.  CTA (g, r) owns a contiguous range of rank
// r's tiles, its warps take them in turn; the peer's CTA (g, peer) owns the
// same range, and a warp waits only for its peer warp's packets of the same
// tile and step, which that warp sends before it waits itself, so the
// protocol cannot deadlock while every CTA is resident.
//
// The epoch, the receive buffers and co-residency are the RD kernel's:
// the flag value comes from the epoch words in device memory
// (RDWorkspace.control, shared with that kernel: every launch moves the
// words on, so a packet of any earlier call never carries the current
// value) and a captured CUDA graph replays the launch correctly; the
// receive rows are the mesh workspace's LL buffer, grown to the largest
// message; the grid is never larger than the CTAs the card holds resident
// at this kernel's occupancy (ops.py), and a wait past ~1 s traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exchange_common.cuh"
#include "quant_common.cuh"

namespace {

using namespace exchange;
using namespace quant;

constexpr int kThreads = 256;            // THREADS in quant_rd_allreduce/ops.py
constexpr int kWarps = kThreads / 32;

// data and scale packets of a tile (DATA_PACKETS, SCALE_PACKETS in
// ops.py), lanes of a group within a half-tile
template <int BITS> constexpr int kDataPk = BITS == 8 ? 64 : 32;
template <int BITS> constexpr int kScalePk = BITS == 8 ? 1 : 2;
template <int BITS> constexpr int kGroupLanes = BITS == 8 ? 32 : 16;

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
quant_rd_allreduce_kernel(const T* x, T* out, unsigned long long* recv,
                          unsigned* ctl, long long m, long long n_tiles,
                          int n, int inner, int vec) {
  __shared__ unsigned s_epoch;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i_ax = (r / inner) % n;
  int steps = 0;
  while ((1 << steps) < n) ++steps;
  const long long n_pk = n_tiles * (kDataPk<BITS> + kScalePk<BITS>);
  const long long sbase = n_tiles * kDataPk<BITS>;   // scale packets
  const long long per = (n_tiles + gridDim.x - 1) / gridDim.x;
  const long long lo = min(n_tiles, blockIdx.x * per);
  const long long hi = min(n_tiles, lo + per);

  // the receive lines of this warp's first tile, one prefetch a line
  if (lo + warp < hi) {
    const long long t = lo + warp;
    for (int s = 0; s < steps; ++s) {
      const unsigned long long* mine =
          recv + (static_cast<long long>(s) * R + r) * n_pk;
      if (lane % 16 == 0) {
        prefetch_l2(mine + t * kDataPk<BITS> + lane);
        if (BITS == 8) prefetch_l2(mine + t * kDataPk<BITS> + 32 + lane);
      }
      if (lane == 0) prefetch_l2(mine + sbase + t * kScalePk<BITS>);
    }
  }
  if (threadIdx.x == 0) s_epoch = epoch_value(ctl, epoch_ticket(ctl));
  __syncthreads();
  const unsigned epoch = s_epoch;

  const T* src = x + r * m;
  T* dst = out + r * m;
  for (long long t = lo + warp; t < hi; t += kWarps) {
    float acc[kPer];
    load_lane(src, t, lane, m, vec, acc);
    for (int s = 0; s < steps; ++s) {
      const int peer = r + ((i_ax ^ (1 << s)) - i_ax) * inner;
      unsigned long long* to_peer =
          recv + (static_cast<long long>(s) * R + peer) * n_pk;
      const unsigned long long* mine =
          recv + (static_cast<long long>(s) * R + r) * n_pk;
      // quantize: the run of each half belongs to one group
      float own_s[2];
      unsigned short sbits[2];
      int q[kPer];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = fabsf(acc[h * kRun]);
#pragma unroll
        for (int i = 1; i < kRun; ++i) a = nan_max(a, fabsf(acc[h * kRun + i]));
        const float scale =
            group_scale<BITS>(lanes_max<kGroupLanes<BITS>>(a));
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          q[h * kRun + i] = quantize<BITS>(acc[h * kRun + i], scale);
        const __nv_bfloat16 sb = __float2bfloat16_rn(scale);
        own_s[h] = __bfloat162float(sb);
        memcpy(&sbits[h], &sb, 2);
      }
      // put: the payload (int8: a packet a half; int4: one packet), then
      // the scales, two a packet: int8 the tile's 2 groups, int4 the
      // groups of lanes 0-15 and 16-31 of each half
      const long long dp = t * kDataPk<BITS> + lane;
      const long long sp = sbase + t * kScalePk<BITS>;
      if (BITS == 8) {
        store_packet(to_peer + dp, pack_int8(q), epoch);
        store_packet(to_peer + dp + 32, pack_int8(q + kRun), epoch);
        if (lane == 0)
          store_packet(to_peer + sp,
                       sbits[0] | static_cast<unsigned>(sbits[1]) << 16, epoch);
      } else {
        store_packet(to_peer + dp, pack_int4(q), epoch);
        const unsigned o0 = __shfl_xor_sync(
            0xffffffffu, static_cast<unsigned>(sbits[0]), 16);
        const unsigned o1 = __shfl_xor_sync(
            0xffffffffu, static_cast<unsigned>(sbits[1]), 16);
        if (lane == 0) {
          store_packet(to_peer + sp, sbits[0] | o0 << 16, epoch);
          store_packet(to_peer + sp + 1, sbits[1] | o1 << 16, epoch);
        }
      }
      // own term, then the peer's
      float peer_s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned pw = BITS == 8 ? wait_packet(mine + sp, epoch)
                                      : wait_packet(mine + sp + h, epoch);
        const int shift = BITS == 8 ? 16 * h : 16 * (lane / 16);
        const unsigned short pb = static_cast<unsigned short>(pw >> shift);
        __nv_bfloat16 psb;
        memcpy(&psb, &pb, 2);
        peer_s[h] = __bfloat162float(psb);
      }
      if (BITS == 8) {
        const unsigned w0 = wait_packet(mine + dp, epoch);
        const unsigned w1 = wait_packet(mine + dp + 32, epoch);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          acc[i] = __fadd_rn(deq(q[i], own_s[0]),
                             deq(int8_at(w0, i), peer_s[0]));
          acc[kRun + i] = __fadd_rn(deq(q[kRun + i], own_s[1]),
                                    deq(int8_at(w1, i), peer_s[1]));
        }
      } else {
        const unsigned w = wait_packet(mine + dp, epoch);
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          acc[e] = __fadd_rn(deq(q[e], own_s[e / kRun]),
                             deq(int4_at(w, e), peer_s[e / kRun]));
      }
    }
    store_lane(dst, t, lane, m, vec, acc);
  }
}

// A plain launch on the port's one stream, as rd_allreduce.cu's
// launch_grid: the wrapper never asks for more CTAs than the card holds
// resident at this kernel's occupancy.
template <typename T, int BITS>
int launch(const void* x, void* out, void* recv, void* ctl, long long m,
           int R, int n, int inner, int pieces, int vec, void* stream) {
  if (R <= 0 || n < 2 || (n & (n - 1)) || inner <= 0 || R % (n * inner) ||
      pieces <= 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  unsigned long long* rp = static_cast<unsigned long long*>(recv);
  unsigned* cp = static_cast<unsigned*>(ctl);
  long long n_tiles = (m + kTile - 1) / kTile;
  void* args[] = {&xp, &op, &rp, &cp, &m, &n_tiles, &n, &inner, &vec};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<void*>(quant_rd_allreduce_kernel<T, BITS>),
      dim3(pieces, R), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int max_ctas(K kern) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per_sm;
}

}  // namespace

// x, out: (R, m) rows of f32 (bf16 when is_bf16), vec: 16-byte aligned
// rows of whole 16-byte vectors; recv: (steps, R, packets) 8-byte packets,
// packets = ceil(m / 256) * (data + scale packets a tile), zero at first
// use; ctl: the epoch words (uint32 [8][32]) of rd_allreduce.cu.  The axis
// has n = 2^k ranks at stride inner.  Grid (pieces, R) on `stream`.
extern "C" int quant_rd_allreduce_launch(const void* x, void* out, void* recv,
                                         void* ctl, long long m, int R, int n,
                                         int inner, int pieces, int bits,
                                         int is_bf16, int vec, void* stream) {
  using bf = __nv_bfloat16;
  if (bits == 8)
    return is_bf16 ? launch<bf, 8>(x, out, recv, ctl, m, R, n, inner, pieces,
                                   vec, stream)
                   : launch<float, 8>(x, out, recv, ctl, m, R, n, inner,
                                      pieces, vec, stream);
  if (bits == 4)
    return is_bf16 ? launch<bf, 4>(x, out, recv, ctl, m, R, n, inner, pieces,
                                   vec, stream)
                   : launch<float, 4>(x, out, recv, ctl, m, R, n, inner,
                                      pieces, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of one launch that the card can hold resident at once (all SMs at
// the kernel's occupancy), or minus a CUDA error code.
extern "C" int quant_rd_allreduce_max_ctas(int bits, int is_bf16) {
  using bf = __nv_bfloat16;
  if (bits == 8)
    return is_bf16 ? max_ctas(quant_rd_allreduce_kernel<bf, 8>)
                   : max_ctas(quant_rd_allreduce_kernel<float, 8>);
  if (bits == 4)
    return is_bf16 ? max_ctas(quant_rd_allreduce_kernel<bf, 4>)
                   : max_ctas(quant_rd_allreduce_kernel<float, 4>);
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
