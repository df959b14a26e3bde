"""Wrapper of the Hopper fused GEMM + recursive-doubling kernel,
``csrc/fused_matmul_rd.cu`` (the port of
``repro/kernels/rd_allreduce/fused_matmul.py::_fused_kernel`` and its
``fused_matmul_rd_call``).

The operands hold the ranks of a virtual mesh on their leading axis, slow
major (rank = pod * fast + f): x (R, M, K), w (R, K, N).  The result
(R, M, N) is every rank's GEMM summed over the slow axis; the fast-axis
sum is the caller's (``core/overlap.py``), as in the TPU kernel.  A CUDA
tensor launches the kernel (or the wrapper raises) and a CPU tensor takes
the plain version in ``ref.py``.  The kernel's receive buffers and flags
live in the mesh's :class:`~repro_torch.kernels.rd_allreduce.RDWorkspace`,
beside kernel 4's, and take their sequence numbers from the same counter.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from ..rd_allreduce import RDWorkspace
from ..rd_allreduce.ref import is_pow2
from .ref import collective_matmul_rd_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (ctypes.c_longlong,) + (_I,) * 7 + (ctypes.c_uint,) \
    + (_I, _I, _P)
SOURCE = "fused_matmul_rd"

_plans: Dict[Tuple, Tuple[int, int]] = {}


def _plan(device: torch.device, M: int, N: int, n_chunks: int, is_bf16: int,
          vec: int) -> Tuple[int, int]:
    """(tiles a rank, CTAs resident at once) of a call shape: the kernel
    picks its tile config from M, and the grid is sized from the card's
    occupancy for that config."""
    key = (device, M, N, n_chunks, is_bf16, vec)
    if key not in _plans:
        tiles = _build.c_function(SOURCE, "fused_matmul_rd_tiles",
                                  (_I, _I, _I))(M, N, n_chunks)
        if tiles < 0:
            raise ValueError(f"collective_matmul_rd: N={N} is not "
                             f"divisible by n_chunks={n_chunks}")
        fn = _build.c_function(SOURCE, "fused_matmul_rd_max_ctas",
                               (_I, _I, _I))
        with torch.cuda.device(device):
            n = fn(is_bf16, vec, M)
        if n < 0:
            _build.check(SOURCE, "fused_matmul_rd_max_ctas", -n)
        if n == 0:
            raise RuntimeError("collective_matmul_rd: no CTA of the kernel "
                               "fits on an SM")
        _plans[key] = (tiles, n)
    return _plans[key]


def collective_matmul_rd(x: torch.Tensor, w: torch.Tensor, pods: int, *,
                         n_chunks: int = 1,
                         workspace: RDWorkspace | None = None
                         ) -> torch.Tensor:
    """x (R, M, K) @ w (R, K, N) on every rank, f32 accumulate, rounded to
    the operand type, then summed over the ``pods`` slow ranks of each
    fast column by recursive doubling, with the step-0 exchange of each
    column block started as soon as it is computed: (R, M, N).

    ``pods`` must be a power of two (1: the GEMM alone); the output does
    not depend on ``n_chunks``, which must divide N.  ``workspace`` (the
    mesh's) is required on CUDA."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"collective_matmul_rd: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (R, M, K) and (R, K, N)")
    R, M, K = x.shape
    N = w.shape[2]
    if pods < 1 or R % pods or not is_pow2(pods):
        raise ValueError(f"collective_matmul_rd: {R} ranks are not a "
                         f"power-of-two pods={pods} times a fast axis")
    if n_chunks < 1 or N % n_chunks:
        raise ValueError(f"collective_matmul_rd: n_chunks={n_chunks} must "
                         f"be >= 1 and divide N={N}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return collective_matmul_rd_ref(x, w, pods, n_chunks=n_chunks)
    if x.device.type != "cuda" or x.dtype not in DTYPES \
            or w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"collective_matmul_rd: expected CUDA tensors of "
                         f"one dtype in {DTYPES}, got {x.dtype} on "
                         f"{x.device} and {w.dtype} on {w.device}")
    if workspace is None:
        raise ValueError("collective_matmul_rd: a CUDA call needs the mesh's "
                         "RDWorkspace")
    xc, wc = x.contiguous(), w.contiguous()
    out = torch.empty((R, M, N), dtype=x.dtype, device=x.device)
    esz = xc.element_size()
    per_vec = 16 // esz
    vec = int(K % per_vec == 0 and (N // n_chunks) % per_vec == 0
              and all(t.data_ptr() % 16 == 0 for t in (xc, wc, out)))
    is_bf16 = int(x.dtype == torch.bfloat16)
    tiles, max_ctas = _plan(x.device, M, N, n_chunks, is_bf16, vec)
    steps = pods.bit_length() - 1
    n_flags = max(1, steps * R * tiles)
    recv, flags = workspace.buffers(x.device, max(1, steps * R * M * N * esz),
                                    n_flags, kernel=SOURCE)
    fn = _build.c_function(SOURCE, "fused_matmul_rd_launch", _ARGTYPES)
    err = fn(xc.data_ptr(), wc.data_ptr(), out.data_ptr(), recv.data_ptr(),
             flags.data_ptr(), n_flags, R, pods, M, K, N, n_chunks,
             min(R * tiles, max_ctas), workspace.next_seq(), is_bf16, vec,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(SOURCE, "collective_matmul_rd", err)
    collective_matmul_rd.launches += 1
    return out


collective_matmul_rd.launches = 0

__all__ = ["collective_matmul_rd", "collective_matmul_rd_ref"]
