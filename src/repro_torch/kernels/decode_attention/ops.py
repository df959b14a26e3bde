"""Wrappers of the Hopper flash-decode kernels, ``csrc/decode_attention.cu``:
dense (``decode_attention``) and paged through a block table
(``paged_decode_attention``).

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import check_index, check_operands
from .ref import decode_attention_ref, paged_decode_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_DENSE_ARGTYPES = (_P,) * 5 + (_I,) * 7 + (_P,)
_PAGED_ARGTYPES = (_P,) * 6 + (_I,) * 8 + (_P,)
HEAD_DIMS = tuple(range(8, 129, 8))
MAX_GROUP_WIDTH = 1024   # g * hd: query heads of one kv head, times hd


def _check(name, q, k, v, Hkv):
    check_operands(name, (q, k, v), HEAD_DIMS)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if (q.shape[1] // Hkv) * q.shape[2] > MAX_GROUP_WIDTH:
        raise ValueError(f"{name}: (Hq/Hkv)*hd > {MAX_GROUP_WIDTH}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd); positions: (B,) int32, the
    last key each sequence sees -> (B, Hq, hd)."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or k.shape != (B, S, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, positions, window=window)
    _check("decode_attention", q, k, v, Hkv)
    check_index("decode_attention positions", positions, (B,), q.device)
    out = torch.empty_like(q)
    fn = _build.c_function("decode_attention", "decode_attention_launch",
                           _DENSE_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
             out.data_ptr(), B, Hq, Hkv, S, hd, int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", "decode_attention", err)
    decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_phys: torch.Tensor,
                           v_phys: torch.Tensor, block_tbl: torch.Tensor,
                           positions: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k_phys/v_phys: (n_blocks, bs, Hkv, hd);
    block_tbl: (B, max_blocks) int32 logical -> physical block, each entry
    below n_blocks (not checked: that would cost a device sync per call;
    entries past a sequence's position may be the trash block 0, they are
    never read); positions: (B,) int32 -> (B, Hq, hd)."""
    B, Hq, hd = q.shape
    nb, bs, Hkv = k_phys.shape[0], k_phys.shape[1], k_phys.shape[2]
    mb = block_tbl.shape[1]
    if Hq % Hkv or k_phys.shape != (nb, bs, Hkv, hd) \
            or v_phys.shape != k_phys.shape or block_tbl.shape[0] != B:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_phys.shape)} v {tuple(v_phys.shape)} "
                         f"tbl {tuple(block_tbl.shape)}")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_phys, v_phys, block_tbl,
                                          positions, window=window)
    _check("paged_decode_attention", q, k_phys, v_phys, Hkv)
    check_index("paged_decode_attention positions", positions, (B,),
                q.device)
    check_index("paged_decode_attention block_tbl", block_tbl, (B, mb),
                q.device)
    out = torch.empty_like(q)
    fn = _build.c_function("decode_attention",
                           "paged_decode_attention_launch", _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_phys.data_ptr(), v_phys.data_ptr(),
             block_tbl.data_ptr(), positions.data_ptr(), out.data_ptr(),
             B, Hq, Hkv, bs, mb, hd, int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", "paged_decode_attention", err)
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0

__all__ = ["decode_attention", "paged_decode_attention",
           "decode_attention_ref", "paged_decode_attention_ref"]
