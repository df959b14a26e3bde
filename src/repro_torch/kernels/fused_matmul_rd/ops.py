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
beside kernel 4's, and its flag value comes from its own epoch words there
(``RDWorkspace.control(device, kernel="fused_matmul_rd")``), kept in device
memory as kernel 4's, so a captured CUDA graph replays a call correctly.
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
_ARGTYPES = (_P,) * 6 + (ctypes.c_longlong,) + (_I,) * 9 + (_P,)
SOURCE = "fused_matmul_rd"

_plans: Dict[Tuple, Tuple[int, int]] = {}


def tile_shape(M: int, is_bf16: bool) -> Tuple[int, int]:
    """(rows, columns) of one output tile of the kernel for M rows a rank
    (``csrc/fused_matmul_rd.cu``): it depends on M and the type only, so
    every output element's sum runs in one order whatever ``n_chunks``.
    bf16: the tensor-core decode form (rows on the mma's n side, 8 or 16)
    up to 16 rows, 128 x 128 tiles above; f32: 16 x 64 and 64 x 64."""
    if is_bf16:
        return (8, 64) if M <= 8 else (16, 64) if M <= 16 else (128, 128)
    return (16, 64) if M <= 16 else (64, 64)


def tiles_per_rank(M: int, N: int, n_chunks: int, is_bf16: bool) -> int:
    """Tiles of one rank's output (and the flags a step needs): every
    column block of N / n_chunks is cut into whole and partial tiles."""
    bm, bn = tile_shape(M, is_bf16)
    return n_chunks * -(-M // bm) * -(-(N // n_chunks) // bn)


def _plan(device: torch.device, M: int, N: int, n_chunks: int, is_bf16: int,
          vec: int) -> Tuple[int, int]:
    """(tiles a rank, CTAs resident at once) of a call shape: the grid is
    sized from the card's occupancy for the tile config; the kernel's own
    tile count must be :func:`tiles_per_rank`'s."""
    key = (device, M, N, n_chunks, is_bf16, vec)
    if key not in _plans:
        tiles = tiles_per_rank(M, N, n_chunks, bool(is_bf16))
        got = _build.c_function(SOURCE, "fused_matmul_rd_tiles",
                                (_I,) * 5)(M, N, n_chunks, is_bf16, vec)
        if got != tiles:
            raise RuntimeError(f"collective_matmul_rd: the kernel counts "
                               f"{got} tiles a rank, the wrapper {tiles}")
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


def vector_ok(tensors, K: int, chunk_w: int) -> bool:
    """K and the column block width are whole 16-byte vectors of the type
    and every pointer is 16-byte aligned: the kernel's vector path, the
    only one its bf16 (tensor-core) form has."""
    per_vec = 16 // tensors[0].element_size()
    return (K % per_vec == 0 and chunk_w % per_vec == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


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
    vec = int(vector_ok((xc, wc, out), K, N // n_chunks))
    is_bf16 = int(x.dtype == torch.bfloat16)
    if is_bf16 and not vec:
        raise ValueError(f"collective_matmul_rd: the bf16 kernel takes K "
                         f"({K}) and N / n_chunks ({N // n_chunks}) in "
                         "multiples of 8 and 16-byte aligned operands")
    tiles, max_ctas = _plan(x.device, M, N, n_chunks, is_bf16, vec)
    steps = pods.bit_length() - 1
    n_flags = max(1, steps * R * tiles)
    recv, flags = workspace.buffers(x.device, max(1, steps * R * M * N * esz),
                                    n_flags, kernel=SOURCE)
    ctl = workspace.control(x.device, kernel=SOURCE)
    fn = _build.c_function(SOURCE, "fused_matmul_rd_launch", _ARGTYPES)
    err = fn(xc.data_ptr(), wc.data_ptr(), out.data_ptr(), recv.data_ptr(),
             flags.data_ptr(), ctl.data_ptr(), n_flags, R, pods, M, K, N,
             n_chunks, min(R * tiles, max_ctas), is_bf16, vec,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(SOURCE, "collective_matmul_rd", err)
    collective_matmul_rd.launches += 1
    return out


collective_matmul_rd.launches = 0

__all__ = ["collective_matmul_rd", "collective_matmul_rd_ref", "tile_shape",
           "tiles_per_rank", "vector_ok"]
