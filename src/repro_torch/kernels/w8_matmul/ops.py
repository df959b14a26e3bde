"""Wrapper of the W8 GEMM, ``csrc/w8_matmul.cu``: x (R, M, K) @ W (R, K, N)
with W held as int8 plus bf16 scales, the weight formed in registers as
``bf16(float(q) * float(s))`` (the reference's ``dequant_layer``) and
multiplied in f32 accumulate.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version in ``ref.py``.  On the card the activations are
bf16 (the serving dtype; an f32 CUDA activation raises), K a multiple of
16 and N of 32.  Rows go 64 a launch; each launch counts one in
``w8_matmul.launches``.  K is cut into ``w8_splits(K)`` splits; above one,
the kernel writes f32 partials to a workspace the wrapper allocates and a
second launch sums them in order (the pair counts once).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import dequant_weight, w8_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 5 + (_P,)
SOURCE = "w8_matmul"
MAX_ROWS = 64        # rows of x a launch (csrc kMaxRows)
COLS = 32            # output columns of a CTA (csrc kCols)
MAX_SPLITS = 8
MAX_TILE = 2048


def w8_splits(K: int) -> int:
    """K's split count, the kernel's ``w8_splits``: up to 8 splits of whole
    k16 steps, at least 64 rows each, more past 2048 rows a split."""
    ks = MAX_SPLITS
    while K // ks > MAX_TILE and ks < K // 16:
        ks *= 2
    while ks > 1 and (K % (16 * ks) or K // ks < 64):
        ks //= 2
    return ks


_checked = set()


def _check_splits(K: int) -> None:
    if K not in _checked:
        got = _build.c_function(SOURCE, "w8_matmul_splits", (_I,))(K)
        if got != w8_splits(K):
            raise RuntimeError(f"w8_matmul: the kernel splits K={K} in {got},"
                               f" the wrapper in {w8_splits(K)}")
        _checked.add(K)


def w8_matmul(x: torch.Tensor, q: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """x (R, M, K); q (R, K, N) int8; s (R, P) bf16 with N % P == 0
    (column n scaled by s[n % P]) -> (R, M, N) in x's type."""
    R, M, K = x.shape
    N = q.shape[2]
    if q.shape != (R, K, N) or s.dim() != 2 or s.shape[0] != R \
            or N % s.shape[1]:
        raise ValueError(f"w8_matmul: shapes x {tuple(x.shape)} q "
                         f"{tuple(q.shape)} s {tuple(s.shape)}")
    if q.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise ValueError(f"w8_matmul: q must be int8 and s bf16, got "
                         f"{q.dtype} / {s.dtype}")
    if x.device.type == "cpu":
        return w8_matmul_ref(x, q, s)
    if q.device != x.device or s.device != x.device:
        raise ValueError("w8_matmul: operands on different devices")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"w8_matmul: the kernel takes bf16 activations, "
                         f"got {x.dtype}")
    if K % 16 or N % COLS:
        raise ValueError(f"w8_matmul: K={K} must be a multiple of 16 and "
                         f"N={N} of {COLS}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()) \
            or q.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("w8_matmul: operands must be contiguous, q 16-byte "
                         "aligned")
    _check_splits(K)
    ks = w8_splits(K)
    out = torch.empty((R, M, N), dtype=x.dtype, device=x.device)
    fn = _build.c_function(SOURCE, "w8_matmul_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for m0 in range(0, M, MAX_ROWS):
        m = min(MAX_ROWS, M - m0)
        xm = x if m == M else x[:, m0:m0 + m].contiguous()
        om = out if m == M else torch.empty((R, m, N), dtype=x.dtype,
                                            device=x.device)
        ws = torch.empty(ks * R * m * N if ks > 1 else 1,
                         dtype=torch.float32, device=x.device)
        err = fn(xm.data_ptr(), q.data_ptr(), s.data_ptr(), om.data_ptr(),
                 ws.data_ptr(), R, m, K, N, s.shape[1], stream)
        _build.check(SOURCE, "w8_matmul", err)
        w8_matmul.launches += 1
        if om is not out:
            out[:, m0:m0 + m] = om
    return out


w8_matmul.launches = 0

__all__ = ["w8_matmul", "w8_matmul_ref", "dequant_weight", "w8_splits"]
