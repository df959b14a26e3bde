"""Operand checks the attention wrappers run before a CUDA launch: the
kernels read 16-byte vectors (or rows of them) of f32 or bf16 and take no
other layout."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

DTYPES = (torch.float32, torch.bfloat16)


def layout_error(tensors: Sequence[torch.Tensor],
                 head_dims: Sequence[int]) -> Optional[str]:
    """Why the kernels cannot read these operands, or None: every tensor
    of one dtype in DTYPES, with a head dim (last dim) in ``head_dims``
    that is contiguous, and with pointer and strides aligned to 16 bytes
    (the bf16 kernels copy 16-byte rows into shared memory, the f32 ones
    load 16-byte vectors).  Device-independent, so the CPU tests reach
    it."""
    t0 = tensors[0]
    if t0.dtype not in DTYPES:
        return f"dtype {t0.dtype} not in {DTYPES}"
    vec = 16 // t0.element_size()
    hd = t0.shape[-1]
    if hd not in head_dims:
        return f"head dim {hd} not in {tuple(head_dims)}"
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            return (f"operands must share device and dtype ({t.device}/"
                    f"{t.dtype} vs {t0.device}/{t0.dtype})")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            return (f"strides {t.stride()} are not 16-byte vectors with a "
                    "contiguous head dim")
        if t.data_ptr() % 16:
            return "data pointer not 16-byte aligned"
    return None


def check_operands(name: str, tensors: Sequence[torch.Tensor],
                   head_dims: Sequence[int]) -> None:
    """Raise unless every tensor is on one CUDA device and
    :func:`layout_error` finds nothing."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t0.device}")
    err = layout_error(tensors, head_dims)
    if err:
        raise ValueError(f"{name}: {err}")


def check_index(name: str, t: torch.Tensor, shape, device) -> None:
    """An int32 index tensor (positions, block table) of ``shape``."""
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


__all__ = ["check_operands", "check_index", "layout_error", "DTYPES"]
