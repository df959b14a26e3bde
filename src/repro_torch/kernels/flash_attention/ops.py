"""Wrappers of the Hopper flash-attention (prefill) kernel,
``csrc/flash_attention.cu``: the full form (``flash_attention``, a prompt's
queries from position 0 over its own keys) and the chunk form
(``flash_attention_chunk``, per-sequence query offsets over the decode
cache, dense or paged).

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .._checks import check_index, check_operands
from .ref import flash_attention_chunk_ref, flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ((_P,) * 4 + (ctypes.POINTER(ctypes.c_longlong),) + (_I,) * 9
             + (_P,))
_CHUNK_ARGTYPES = ((_P,) * 4 + (ctypes.POINTER(ctypes.c_longlong),)
                   + (_P,) * 3 + (_I,) * 10 + (_P,))
HEAD_DIMS = (16, 32, 64, 128)


def _strides(*ts: torch.Tensor):
    """The kernels' 12 element strides: the first three of each tensor."""
    return (ctypes.c_longlong * 12)(*(s for t in ts for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd).

    Keys past Skv never exist (no padding is applied), so ragged lengths
    need no ``kv_len``.  On CUDA the operands may be strided views (e.g.
    (B, S, H, hd) transposed) as long as ``hd`` is contiguous; the output
    is then laid out (B, Sq, Hq, hd) in memory and returned as its
    (B, Hq, Sq, hd) view, so that the caller's transpose back is free.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv or k.shape != (B, Hkv, Skv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    check_operands("flash_attention", (q, k, v), HEAD_DIMS)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = _strides(q, k, v, out)
    fn = _build.c_function("flash_attention", "flash_attention_launch",
                           _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             strides, B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention", err)
    flash_attention.launches += 1
    return out


def flash_attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: torch.Tensor, *,
                          rows: Optional[torch.Tensor] = None,
                          block_tbl: Optional[torch.Tensor] = None,
                          window: int = 0) -> torch.Tensor:
    """The chunk form, causal: q (N, Hq, C, hd), sequence n's queries at
    absolute positions ``q_offset[n] + [0, C)`` ((N,) int32 on the
    device); its keys in the decode cache, either dense, k/v (R, S_max, U,
    hd) with sequence n reading row ``rows[n]`` ((N,) int32), or paged,
    k/v the pool (n_blocks, bs, U, hd) with sequence n reading through
    ``block_tbl[n]`` ((N, max_blocks) int32, entries below n_blocks: not
    checked, that would cost a sync) -> (N, Hq, C, hd).  Key p is visible
    iff p <= qpos (and p > qpos - window); keys past the chunk's last
    query are never read.  Offsets, rows and table are read on the device,
    so one CUDA graph serves any of them.  On CUDA q may be a strided view
    as in :func:`flash_attention`, and the output is laid out (N, C, Hq,
    hd) and returned as its (N, Hq, C, hd) view."""
    N, Hq, C, hd = q.shape
    if (rows is None) == (block_tbl is None):
        raise ValueError("flash_attention_chunk: give rows (dense) or "
                         "block_tbl (paged), not both")
    Hkv = k.shape[2]
    if Hq % Hkv or k.dim() != 4 or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention_chunk: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_chunk_ref(q, k, v, q_offset, rows=rows,
                                         block_tbl=block_tbl, window=window)
    check_operands("flash_attention_chunk", (q, k, v), HEAD_DIMS)
    check_index("flash_attention_chunk q_offset", q_offset, (N,), q.device)
    if block_tbl is None:
        check_index("flash_attention_chunk rows", rows, (N,), q.device)
        bs, mb, n_keys = 0, 0, k.shape[1]
    else:
        mb, bs = block_tbl.shape[1], k.shape[1]
        check_index("flash_attention_chunk block_tbl", block_tbl, (N, mb),
                    q.device)
        n_keys = bs * mb
    out = torch.empty((N, C, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    # k/v strides as (row or block, head, position)
    kv = [t.permute(0, 2, 1, 3) for t in (k, v)]
    fn = _build.c_function("flash_attention", "flash_attention_chunk_launch",
                           _CHUNK_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _strides(q, *kv, out), q_offset.data_ptr(),
             None if rows is None else rows.data_ptr(),
             None if block_tbl is None else block_tbl.data_ptr(), N, Hq, Hkv,
             C, n_keys, hd, bs, mb, int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention_chunk", err)
    flash_attention_chunk.launches += 1
    return out


flash_attention.launches = 0
flash_attention_chunk.launches = 0

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_chunk",
           "flash_attention_chunk_ref"]
