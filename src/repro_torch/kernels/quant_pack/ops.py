"""Wrappers of the Hopper group-quantized pack and unpack kernels,
``csrc/quant_pack.cu`` (the port of ``kernels/rd_allreduce/quant_kernel.py
::_quantize_kernel`` and ``::_dequant_kernel``): the wire format of the
quantized collectives of :mod:`repro_torch.core.hierarchical`.

:func:`quantize_pack` takes any leading shape and runs on the contiguous
flat layout (a group never crosses a row, since D is a multiple of it);
with ``err=True`` it also returns the rounding residue ``x - deq(Q(x))``
in the same pass.  :func:`unpack_dequant` reads its payload and scales as
strided views whose last dim is contiguous (an all-to-all's transpose, an
all-gather's broadcast: no copy), sums an optional piece dim in index
order, and can write into a strided f32 view (``out``).  A CUDA tensor
launches the kernel (or the wrapper raises) and counts one launch on the
wrapper; a CPU tensor takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from .ref import GROUP_CAP, QMAX, quantize_pack as quantize_pack_ref, \
    quantize_pack_err as quantize_pack_err_ref, \
    unpack_dequant as unpack_dequant_ref, \
    unpack_dequant_sum as unpack_dequant_sum_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_PACK_ARGTYPES = (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P)
_UNPACK_ARGTYPES = (_P, _P, _P, _P, _I, _P)
# Row dims the unpack kernel takes after collapsing (kMaxDims in
# csrc/quant_pack.cu).
MAX_DIMS = 6


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


def quantize_pack(x: torch.Tensor, bits: int, group: int, *,
                  err: bool = False) -> Tuple[torch.Tensor, ...]:
    """(..., D) f32/bf16 -> (packed int8 (..., D or D/2), scales bf16
    (..., D/group)), and with ``err`` the f32 residue ``x - deq(Q(x))``
    (..., D) as a third tensor."""
    D = x.shape[-1]
    _check("quantize_pack", bits, group, D)
    if x.device.type == "cpu":
        return (quantize_pack_err_ref if err else quantize_pack_ref)(
            x, bits, group)
    if x.device.type != "cuda" or x.dtype not in DTYPES:
        raise ValueError(f"quantize_pack: expected a CUDA tensor of "
                         f"{DTYPES}, got {x.dtype} on {x.device}")
    xc = x.contiguous()
    lead = x.shape[:-1]
    packed = torch.empty((*lead, D if bits == 8 else D // 2),
                         dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, D // group), dtype=torch.bfloat16,
                         device=x.device)
    res = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if err else None
    if xc.numel():
        fn = _build.c_function("quant_pack", "quantize_pack_launch",
                               _PACK_ARGTYPES)
        rc = fn(xc.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                res.data_ptr() if err else None, xc.numel(), bits, group,
                int(x.dtype == torch.bfloat16), int(xc.data_ptr() % 16 == 0),
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check("quant_pack", "quantize_pack", rc)
        quantize_pack.launches += 1
    return (packed, scales, res) if err else (packed, scales)


def _collapse(dims: List[List[int]]) -> List[List[int]]:
    """Row dims [size, *strides] with size-1 dims dropped and neighbours
    merged where every tensor steps over both as over one."""
    out: List[List[int]] = []
    for d in dims:
        if d[0] == 1:
            continue
        if out and all(a == b * d[0] for a, b in zip(out[-1][1:], d[1:])):
            out[-1] = [out[-1][0] * d[0], *d[1:]]
        else:
            out.append(list(d))
    return out


def unpack_geometry(packed: torch.Tensor, scales: torch.Tensor,
                    out: torch.Tensor, bits: int, group: int,
                    piece_dim: Optional[int]) -> List[int]:
    """The int64 geometry ``csrc/quant_pack.cu::unpack_dequant_launch``
    reads (sizes and strides of the views, collapsed; pieces; the vector
    condition), or ValueError past ``MAX_DIMS`` row dims.  Pure Python, so
    the CPU tests reach it."""
    D = out.shape[-1]
    lead = list(range(packed.dim() - 1))
    n, pps, pss = 1, 0, 0
    if piece_dim is not None:
        lead.remove(piece_dim)
        n = packed.shape[piece_dim]
        pps, pss = packed.stride(piece_dim), scales.stride(piece_dim)
    dims = [[packed.shape[k], packed.stride(k), scales.stride(k),
             out.stride(i)] for i, k in enumerate(lead)]
    dims = _collapse(dims)
    # rows contiguous in all three: one longer row (groups stay aligned)
    if dims and dims[-1][1:] == [packed.shape[-1], scales.shape[-1], D]:
        D *= dims.pop()[0]
    if len(dims) > MAX_DIMS:
        raise ValueError(f"unpack_dequant: {len(dims)} row dims after "
                         f"collapsing, the kernel takes {MAX_DIMS}")
    # the kernel reads a run of 4 payload elements (4 or 2 bytes) at once
    align = 4 if bits == 8 else 2
    vec = (packed.data_ptr() % align == 0 and out.data_ptr() % 16 == 0
           and all(d[1] % align == 0 and d[3] % 4 == 0 for d in dims)
           and pps % align == 0)
    geom = [len(dims), n, group, int(vec), D, pps, pss]
    for d in dims:
        geom += d
    return geom


def _out_shape(packed: torch.Tensor, D: int,
               piece_dim: Optional[int]) -> Tuple[int, ...]:
    lead = list(packed.shape[:-1])
    if piece_dim is not None:
        del lead[piece_dim]
    return (*lead, D)


def unpack_dequant(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                   group: int, *, piece_dim: Optional[int] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`: (packed (..., Dp), scales
    (..., D/group)) -> f32 (..., D).  With ``piece_dim`` (a dim of the
    payload other than the last) the pieces along it are summed in index
    order and the dim is dropped.  With ``out`` (f32, the result's shape,
    last dim contiguous; any other strides) the result is written there."""
    D = packed.shape[-1] * (2 if bits == 4 else 1)
    _check("unpack_dequant", bits, group, D)
    if scales.shape != (*packed.shape[:-1], D // group):
        raise ValueError(f"unpack_dequant: scales {tuple(scales.shape)} do "
                         f"not match packed {tuple(packed.shape)} at group "
                         f"{group}")
    if piece_dim is not None:
        piece_dim %= packed.dim()
        if piece_dim == packed.dim() - 1:
            raise ValueError("unpack_dequant: the piece dim cannot be the "
                             "payload's last dim")
    shape = _out_shape(packed, D, piece_dim)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or out.device != packed.device
                            or (D > 1 and out.stride(-1) != 1)):
        raise ValueError(f"unpack_dequant: out must be f32 {shape} on "
                         f"{packed.device} with a contiguous last dim, got "
                         f"{out.dtype} {tuple(out.shape)} strides "
                         f"{out.stride()} on {out.device}")
    if packed.device.type == "cpu":
        res = (unpack_dequant_ref(packed, scales, bits, group)
               if piece_dim is None else
               unpack_dequant_sum_ref(packed, scales, bits, group,
                                      piece_dim))
        return res if out is None else out.copy_(res)
    if packed.device.type != "cuda" or packed.dtype != torch.int8 \
            or scales.dtype != torch.bfloat16 \
            or scales.device != packed.device:
        raise ValueError(f"unpack_dequant: expected CUDA int8 payload and "
                         f"bf16 scales on one device, got {packed.dtype} on "
                         f"{packed.device}, {scales.dtype} on "
                         f"{scales.device}")
    if packed.stride(-1) != 1 or scales.stride(-1) != 1:
        raise ValueError(f"unpack_dequant: the payload's and the scales' "
                         f"last dims must be contiguous, got strides "
                         f"{packed.stride()} and {scales.stride()}")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=packed.device)
    if out.numel():
        geom = unpack_geometry(packed, scales, out, bits, group, piece_dim)
        fn = _build.c_function("quant_pack", "unpack_dequant_launch",
                               _UNPACK_ARGTYPES)
        arr = (ctypes.c_longlong * len(geom))(*geom)
        rc = fn(packed.data_ptr(), scales.data_ptr(), out.data_ptr(), arr,
                bits, torch.cuda.current_stream(packed.device).cuda_stream)
        _build.check("quant_pack", "unpack_dequant", rc)
        unpack_dequant.launches += 1
    return out


quantize_pack.launches = 0
unpack_dequant.launches = 0

__all__ = ["quantize_pack", "unpack_dequant", "unpack_geometry"]
