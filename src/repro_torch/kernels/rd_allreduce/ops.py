"""Wrapper of the Hopper recursive-doubling all-reduce kernel,
``csrc/rd_allreduce.cu`` (the port of ``kernels/rd_allreduce/kernel.py
::_rd_kernel`` and its ``ops.py::rd_all_reduce_pallas``).

The operand holds the ranks of a virtual mesh on its leading axis, slow
major (rank = pod * fast + f).  ``pods == 1`` (identity) and a
non-power-of-two ``pods`` (plain sum) are the reference's own dispatch and
stay so on every device.  Otherwise a CUDA tensor launches the kernel (or
the wrapper raises) and a CPU tensor takes the plain version in ``ref.py``.

The kernel's receive buffers and flags persist across calls in an
:class:`RDWorkspace`, which the mesh owns (the port's analogue of
NVSHMEM's symmetric heap): it grows to the largest message and is reused
by every later call on the same stream, and the kernel allocates nothing.
The fused GEMM + recursive-doubling kernel
(:mod:`repro_torch.kernels.fused_matmul_rd`) keeps its own buffers and
flags in the same workspace and draws from the same sequence counter.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from .ref import is_pow2, rd_all_reduce_ref, slow_sum

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 4 + (ctypes.c_longlong,) + (_I,) * 5 + (ctypes.c_uint,) \
    + (_I, _I, _P)
THREADS = 256            # kThreads in csrc/rd_allreduce.cu
UNITS_PER_THREAD = 2     # 16-byte vectors per thread a piece aims for
_SEQ_WRAP = 2**31 - 1


def rd_pieces(m_units: int, n_ranks: int, n_chunks: int,
              max_ctas: int) -> int:
    """CTAs per chunk of one rank's row: enough that each thread moves
    about ``UNITS_PER_THREAD`` vectors, no more than keep the whole grid
    (n_ranks x n_chunks x the result) resident on the card at once."""
    cap = max_ctas // (n_ranks * n_chunks)
    if cap < 1:
        raise ValueError(
            f"rd_all_reduce: {n_ranks} ranks x {n_chunks} chunks need more "
            f"CTAs than the {max_ctas} the card holds resident at once")
    per_chunk = -(-m_units // n_chunks)
    return min(cap, max(1, -(-per_chunk // (THREADS * UNITS_PER_THREAD))))


class RDWorkspace:
    """Receive buffers and flags of the exchange kernels, per device and
    per kernel (``kernel`` names it: "rd" for this kernel's (steps, R, m)
    buffers and (steps, R, stride) flags, "fused_matmul_rd" for the fused
    kernel's), plus the sequence number of the next call.

    The two kernels' flags are separate arrays, and both kernels take
    their numbers from the one counter (:meth:`next_seq`): every launch,
    of either kernel, waits for a number no earlier launch has written, so
    a flag left by any earlier call can never satisfy it.  Flags start at
    zero and only ever hold a call's sequence number, so they are never
    reset; a buffer grows (flags zeroed anew) when a call needs more, and
    is never shrunk or reallocated per call."""

    def __init__(self):
        self._recv: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._flags: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._seq = 0

    def buffers(self, device: torch.device, recv_bytes: int, n_flags: int,
                kernel: str = "rd") -> Tuple[torch.Tensor, torch.Tensor]:
        key = (kernel, device)
        recv = self._recv.get(key)
        if recv is None or recv.numel() < recv_bytes:
            recv = torch.empty(recv_bytes, dtype=torch.uint8, device=device)
            self._recv[key] = recv
        flags = self._flags.get(key)
        if flags is None or flags.numel() < n_flags:
            flags = torch.zeros(n_flags, dtype=torch.int32, device=device)
            self._flags[key] = flags
        return recv, flags

    def next_seq(self) -> int:
        self._seq = self._seq % _SEQ_WRAP + 1
        return self._seq

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for d in (self._recv, self._flags) for t in d.values())


_max_ctas: Dict[Tuple, int] = {}


def _resident_ctas(device: torch.device, is_bf16: int, vec: int) -> int:
    key = (device, is_bf16, vec)
    if key not in _max_ctas:
        fn = _build.c_function("rd_allreduce", "rd_allreduce_max_ctas",
                               (_I, _I))
        with torch.cuda.device(device):
            n = fn(is_bf16, vec)
        if n < 0:
            _build.check("rd_allreduce", "rd_allreduce_max_ctas", -n)
        if n == 0:
            raise RuntimeError("rd_all_reduce: no CTA of the kernel fits "
                               "on an SM")
        _max_ctas[key] = n
    return _max_ctas[key]


def rd_all_reduce(x: torch.Tensor, pods: int, *, n_chunks: int = 1,
                  workspace: RDWorkspace | None = None) -> torch.Tensor:
    """x (R, ...), R = pods * fast ranks slow-major -> the sum over the
    slow axis on every rank, in x's shape and type.

    log2(pods) XOR-peer steps in one launch; ``n_chunks`` pieces per rank
    are exchanged independently (each split further over CTAs), which
    never changes the result.  ``workspace`` (the mesh's) is required on
    CUDA."""
    R = x.shape[0]
    if pods < 1 or R % pods:
        raise ValueError(f"rd_all_reduce: {R} ranks are not pods={pods} "
                         "times a fast axis")
    if n_chunks < 1:
        raise ValueError(f"rd_all_reduce: n_chunks={n_chunks} must be >= 1")
    if pods == 1:
        return x
    if not is_pow2(pods):
        return slow_sum(x, pods)
    if x.device.type == "cpu":
        return rd_all_reduce_ref(x, pods, n_chunks=n_chunks)
    if x.device.type != "cuda" or x.dtype not in DTYPES:
        raise ValueError(f"rd_all_reduce: expected a CUDA tensor of "
                         f"{DTYPES}, got {x.dtype} on {x.device}")
    if workspace is None:
        raise ValueError("rd_all_reduce: a CUDA call needs the mesh's "
                         "RDWorkspace")
    xc = x.contiguous()
    m = xc[0].numel()
    esz = xc.element_size()
    vec = int((m * esz) % 16 == 0 and xc.data_ptr() % 16 == 0)
    is_bf16 = int(x.dtype == torch.bfloat16)
    units = m // (16 // esz) if vec else m
    max_ctas = _resident_ctas(x.device, is_bf16, vec)
    per_chunk = rd_pieces(units, R, n_chunks, max_ctas)
    steps = pods.bit_length() - 1
    recv, flags = workspace.buffers(x.device, steps * R * m * esz,
                                    steps * R * max_ctas)
    out = torch.empty_like(xc)
    fn = _build.c_function("rd_allreduce", "rd_allreduce_launch", _ARGTYPES)
    err = fn(xc.data_ptr(), out.data_ptr(), recv.data_ptr(), flags.data_ptr(),
             m, R, pods, n_chunks, per_chunk, max_ctas, workspace.next_seq(),
             is_bf16, vec, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("rd_allreduce", "rd_all_reduce", err)
    rd_all_reduce.launches += 1
    return out.view(x.shape)


rd_all_reduce.launches = 0

__all__ = ["rd_all_reduce", "rd_all_reduce_ref", "RDWorkspace", "rd_pieces"]
