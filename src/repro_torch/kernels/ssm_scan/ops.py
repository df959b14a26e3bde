"""Wrapper of the Hopper Mamba selective-scan kernel, ``csrc/ssm_scan.cu``
(the port of ``repro/kernels/ssm_scan/kernel.py::_ssm_kernel`` and its
``ssm_scan`` wrapper, which padded T to its chunk and Ci to 128 lanes: the
CUDA kernel masks both and takes any T >= 1 and any Ci).

A CUDA tensor launches the kernel (or the wrapper raises); CPU tensors
take the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.  ``b`` and ``c`` may be the two
halves of one (N, T, 2S) tensor (the mixer's ``bc`` projection): the kernel
reads their rows at a stride, so neither is copied.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 6 + (_P,)
SOURCE = "ssm_scan"
STATE_DIMS = (8, 16)


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The element stride between consecutive (n, t) rows of an (N, T, S)
    operand whose rows are contiguous and evenly spaced (a contiguous
    tensor, or a last-dim slice of one (N, T, W) tensor), else None."""
    N, T, S = t.shape
    if S > 1 and t.stride(2) != 1:
        return None
    if T > 1:
        rs = t.stride(1)
        return rs if N == 1 or t.stride(0) == T * rs else None
    return t.stride(0) if N > 1 else S


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             h_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective-scan recurrence over T steps, f32 throughout:
    ``h <- exp(a dt_t) h + (dt_t x_t) b_t^T``, ``y_t = h c_t``.

    x/dt: (N, T, Ci) f32; b/c: (N, T, S) f32 (on the card: rows of S
    contiguous floats evenly spaced by one stride, as contiguous tensors or
    the halves of one (N, T, 2S) tensor are); a: (G, Ci, S) f32 with G
    dividing N, sequence n reading group n // (N // G) (the ranks of a
    virtual mesh folded into the sequences, each with its own channels'
    A); h0: (N, Ci, S) f32 or None (zero state).  Returns (y (N, T, Ci),
    the final state).  The final state goes to ``h_out`` when given, which
    may be ``h0`` itself (an in-place update, the decode path's cache)."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} and dt "
                         f"{tuple(dt.shape)} are not one (N, T, Ci)")
    N, T, Ci = x.shape
    if b.dim() != 3 or tuple(b.shape[:2]) != (N, T) or c.shape != b.shape:
        raise ValueError(f"ssm_scan: b {tuple(b.shape)} and c "
                         f"{tuple(c.shape)} are not one ({N}, {T}, S)")
    S = b.shape[-1]
    state = (N, Ci, S)
    if a.dim() != 3 or tuple(a.shape[1:]) != (Ci, S) or a.shape[0] < 1 \
            or N % a.shape[0] or T < 1:
        raise ValueError(f"ssm_scan: a {tuple(a.shape)} is not (G, {Ci}, "
                         f"{S}) with G dividing N={N}, or T={T} < 1")
    for name, t in (("h0", h0), ("h_out", h_out)):
        if t is not None and tuple(t.shape) != state:
            raise ValueError(f"ssm_scan: {name} {tuple(t.shape)} is not "
                             f"{state}")
    ops = [t for t in (x, dt, b, c, a, h0, h_out) if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        y, h = ssm_scan_ref(x, dt, b, c, a, h0)
        return y, h if h_out is None else h_out.copy_(h)
    if x.device.type != "cuda" or any(
            t.device != x.device or t.dtype != torch.float32 for t in ops):
        raise ValueError(
            "ssm_scan: expected float32 CUDA tensors on one device, got "
            f"{[(t.dtype, str(t.device)) for t in ops]}")
    if S not in STATE_DIMS:
        raise ValueError(f"ssm_scan: state dim {S} not in {STATE_DIMS}")
    y = torch.empty_like(x)
    if h_out is None:
        h_out = torch.empty(state, dtype=torch.float32, device=x.device)
    dense = [t for t in (x, dt, a, h0, y, h_out) if t is not None]
    rs = row_stride(b)
    if (rs is None or row_stride(c) != rs or rs % 4
            or not all(t.is_contiguous() for t in dense)
            or any(t.data_ptr() % 16 for t in dense + [b, c])):
        raise ValueError("ssm_scan: operands must be contiguous and 16-byte "
                         "aligned (b and c: rows of S contiguous floats, "
                         "one stride, a multiple of 4, apart)")
    fn = _build.c_function(SOURCE, "ssm_scan_launch", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
             a.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_out.data_ptr(), N, T, Ci, S, a.shape[0], rs,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(SOURCE, "ssm_scan", err)
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0

__all__ = ["ssm_scan", "ssm_scan_ref"]
