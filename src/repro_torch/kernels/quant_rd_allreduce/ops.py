"""Wrapper of the Hopper quantized recursive-doubling all-reduce,
``csrc/quant_rd_allreduce.cu``: the slow phase of the quantized wire
(``ar_quant`` int8 / int4 under ``hier_rd`` and ``hier_rd_halving``), the
pack, the XOR exchange and the unpack of every step in one launch, where
the reference calls ``kernels/rd_allreduce/quant_kernel.py``'s pack and
unpack around a ``lax.ppermute`` at each step.

The operand is the (P, F, *s) view of a rank-stacked tensor; the sum runs
over ``axis`` (0: the pods, 1: the fast ranks), whose size must be a power
of two of at least 2 (``core/hierarchical.py`` keeps the reference's
identity and plain-sum cases).  A CUDA tensor launches the kernel (or the
wrapper raises) and counts one launch; a CPU tensor takes the plain loop
in ``ref.py``.

The kernel exchanges LL packets (4 payload bytes beside the call's epoch
in one 8-byte store) through the mesh's :class:`~repro_torch.kernels.
rd_allreduce.RDWorkspace`: its LL receive buffer, grown to the largest
message, and its epoch words in device memory, which it shares with the
recursive-doubling kernel, so a captured call replays in a CUDA graph.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from ..quant_pack.ref import QMAX
from ..rd_allreduce.ops import RDWorkspace
from ..rd_allreduce.ref import is_pow2
from .ref import quant_rd_all_reduce_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 4 + (ctypes.c_longlong,) + (_I,) * 7 + (_P,)
THREADS = 256            # kThreads in csrc/quant_rd_allreduce.cu
WARPS = THREADS // 32
TILE = 256               # elements a warp-tile: 8 a lane
# Packets of a tile: the payload (4 bytes a packet) and the bf16 scales
# (two a packet) of int8 group 128 and int4 group 64.
DATA_PACKETS = {8: 64, 4: 32}
SCALE_PACKETS = {8: 1, 4: 2}


def qrd_tiles(m: int) -> int:
    """Warp-tiles of a rank's message of m elements (padded to 256)."""
    return -(-m // TILE)


def qrd_packets(m: int, bits: int) -> int:
    """8-byte packets a rank sends at each step: every tile's payload
    packets, then every tile's scale packets."""
    return qrd_tiles(m) * (DATA_PACKETS[bits] + SCALE_PACKETS[bits])


def qrd_recv_bytes(steps: int, n_ranks: int, m: int, bits: int) -> int:
    """The receive buffers, (steps, R, packets) of 8 bytes."""
    return steps * n_ranks * qrd_packets(m, bits) * 8


def qrd_plan(n_tiles: int, n_ranks: int, max_ctas: int) -> int:
    """CTAs a rank: one tile a warp where the card holds that many CTAs
    resident at once, else as many as stay resident (a warp then walks its
    CTA's tiles in turn)."""
    cap = max_ctas // n_ranks
    if cap < 1:
        raise ValueError(
            f"quant_rd_all_reduce: {n_ranks} ranks need more CTAs than the "
            f"{max_ctas} the card holds resident at once")
    return max(1, min(cap, -(-n_tiles // WARPS)))


_max_ctas: Dict[Tuple, int] = {}


def _resident_ctas(device: torch.device, bits: int, is_bf16: int) -> int:
    key = (device, bits, is_bf16)
    if key not in _max_ctas:
        fn = _build.c_function("quant_rd_allreduce",
                               "quant_rd_allreduce_max_ctas", (_I, _I))
        with torch.cuda.device(device):
            n = fn(bits, is_bf16)
        if n < 0:
            _build.check("quant_rd_allreduce", "quant_rd_allreduce_max_ctas",
                         -n)
        if n == 0:
            raise RuntimeError("quant_rd_all_reduce: no CTA of the kernel "
                               "fits on an SM")
        _max_ctas[key] = n
    return _max_ctas[key]


def quant_rd_all_reduce(t: torch.Tensor, axis: int, bits: int, *,
                        workspace: RDWorkspace | None = None
                        ) -> torch.Tensor:
    """t (P, F, *s) f32/bf16 -> the quantized recursive-doubling sum over
    ``axis`` on every rank, in t's shape and type: at each of the
    log2(n) steps ``acc <- deq(Q(acc)) + deq(Q(acc_peer))`` at the group
    cap over each rank's message, bitwise equal to :func:`ref.
    quant_rd_all_reduce_ref`.  ``workspace`` (the mesh's) is required on
    CUDA."""
    if bits not in QMAX:
        raise ValueError(f"quant_rd_all_reduce: bits={bits} not in "
                         f"{tuple(QMAX)}")
    if t.dim() < 2 or axis not in (0, 1):
        raise ValueError(f"quant_rd_all_reduce: axis={axis} of a "
                         f"{t.dim()}-d (P, F, ...) tensor")
    n = t.shape[axis]
    if n < 2 or not is_pow2(n):
        raise ValueError(f"quant_rd_all_reduce: axis of size {n} is not a "
                         "power of two >= 2")
    if t.device.type == "cpu":
        return quant_rd_all_reduce_ref(t, axis, bits)
    if t.device.type != "cuda" or t.dtype not in DTYPES:
        raise ValueError(f"quant_rd_all_reduce: expected a CUDA tensor of "
                         f"{DTYPES}, got {t.dtype} on {t.device}")
    if workspace is None:
        raise ValueError("quant_rd_all_reduce: a CUDA call needs the mesh's "
                         "RDWorkspace")
    tc = t.contiguous()
    P, Fn = t.shape[:2]
    R = P * Fn
    m = tc.numel() // R
    out = torch.empty_like(tc)
    if m == 0:
        return out
    is_bf16 = int(t.dtype == torch.bfloat16)
    steps = n.bit_length() - 1
    pieces = qrd_plan(qrd_tiles(m), R,
                      _resident_ctas(t.device, bits, is_bf16))
    recv = workspace.ll_buffer(t.device, qrd_recv_bytes(steps, R, m, bits))
    ctl = workspace.control(t.device)
    vec = int(tc.data_ptr() % 16 == 0 and (m * tc.element_size()) % 16 == 0)
    fn = _build.c_function("quant_rd_allreduce", "quant_rd_allreduce_launch",
                           _ARGTYPES)
    rc = fn(tc.data_ptr(), out.data_ptr(), recv.data_ptr(), ctl.data_ptr(), m,
            R, n, Fn if axis == 0 else 1, pieces, bits, is_bf16, vec,
            torch.cuda.current_stream(t.device).cuda_stream)
    _build.check("quant_rd_allreduce", "quant_rd_all_reduce", rc)
    quant_rd_all_reduce.launches += 1
    return out.view(t.shape)


quant_rd_all_reduce.launches = 0

__all__ = ["quant_rd_all_reduce", "qrd_tiles", "qrd_packets",
           "qrd_recv_bytes", "qrd_plan"]
