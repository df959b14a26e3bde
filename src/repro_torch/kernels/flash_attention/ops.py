"""Wrapper of the Hopper flash-attention (prefill) kernel,
``csrc/flash_attention.cu``.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import check_operands
from .ref import flash_attention_ref

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.POINTER(ctypes.c_longlong),)
             + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))
HEAD_DIMS = (16, 32, 64, 128)


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
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.c_function("flash_attention", "flash_attention_launch",
                           _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             strides, B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_ref"]
