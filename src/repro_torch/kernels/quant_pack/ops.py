"""Wrappers of the Hopper group-quantized pack and unpack kernels,
``csrc/quant_pack.cu`` (the port of ``kernels/rd_allreduce/quant_kernel.py
::_quantize_kernel`` and ``::_dequant_kernel``): the wire format of every
quantized collective of :mod:`repro_torch.core.hierarchical`.

Both take any leading shape and run on the 2-D (rows, D) view of a
contiguous copy, which is the flat layout the kernels walk (a group never
crosses a row, since D is a multiple of it).  A CUDA tensor launches the
kernel (or the wrapper raises) and counts one launch on the wrapper; a
CPU tensor takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .._checks import DTYPES
from .ref import GROUP_CAP, QMAX, quantize_pack as quantize_pack_ref, \
    unpack_dequant as unpack_dequant_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_PACK_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P)
_UNPACK_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, _I, _I, _P)


def _check(name: str, bits: int, group: int, D: int) -> None:
    if bits not in QMAX:
        raise ValueError(f"{name}: bits={bits} not in {tuple(QMAX)}")
    if group < 1 or group > max(GROUP_CAP.values()) or group & (group - 1):
        raise ValueError(f"{name}: group={group} is not a power of two in "
                         "1..128")
    if D % group or (bits == 4 and D % 2):
        raise ValueError(f"{name}: trailing dim {D} does not split into "
                         f"groups of {group}" + (" and nibble pairs"
                                                 if bits == 4 else ""))


def quantize_pack(x: torch.Tensor, bits: int,
                  group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) f32/bf16 -> (packed int8 (..., D or D/2), scales bf16
    (..., D/group))."""
    D = x.shape[-1]
    _check("quantize_pack", bits, group, D)
    if x.device.type == "cpu":
        return quantize_pack_ref(x, bits, group)
    if x.device.type != "cuda" or x.dtype not in DTYPES:
        raise ValueError(f"quantize_pack: expected a CUDA tensor of "
                         f"{DTYPES}, got {x.dtype} on {x.device}")
    xc = x.contiguous()
    lead = x.shape[:-1]
    packed = torch.empty((*lead, D if bits == 8 else D // 2),
                         dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, D // group), dtype=torch.bfloat16,
                         device=x.device)
    if xc.numel():
        fn = _build.c_function("quant_pack", "quantize_pack_launch",
                               _PACK_ARGTYPES)
        err = fn(xc.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                 xc.numel(), bits, group, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check("quant_pack", "quantize_pack", err)
        quantize_pack.launches += 1
    return packed, scales


def unpack_dequant(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                   group: int) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`: (packed (..., Dp), scales
    (..., D/group)) -> f32 (..., D)."""
    D = packed.shape[-1] * (2 if bits == 4 else 1)
    _check("unpack_dequant", bits, group, D)
    if scales.shape != (*packed.shape[:-1], D // group):
        raise ValueError(f"unpack_dequant: scales {tuple(scales.shape)} do "
                         f"not match packed {tuple(packed.shape)} at group "
                         f"{group}")
    if packed.device.type == "cpu":
        return unpack_dequant_ref(packed, scales, bits, group)
    if packed.device.type != "cuda" or packed.dtype != torch.int8 \
            or scales.dtype != torch.bfloat16 \
            or scales.device != packed.device:
        raise ValueError(f"unpack_dequant: expected CUDA int8 payload and "
                         f"bf16 scales on one device, got {packed.dtype} on "
                         f"{packed.device}, {scales.dtype} on "
                         f"{scales.device}")
    pc, sc = packed.contiguous(), scales.contiguous()
    out = torch.empty((*packed.shape[:-1], D), dtype=torch.float32,
                      device=packed.device)
    if pc.numel():
        fn = _build.c_function("quant_pack", "unpack_dequant_launch",
                               _UNPACK_ARGTYPES)
        err = fn(pc.data_ptr(), sc.data_ptr(), out.data_ptr(), pc.numel(),
                 bits, group,
                 torch.cuda.current_stream(packed.device).cuda_stream)
        _build.check("quant_pack", "unpack_dequant", err)
        unpack_dequant.launches += 1
    return out


quantize_pack.launches = 0
unpack_dequant.launches = 0

__all__ = ["quantize_pack", "unpack_dequant"]
