"""Wrapper of the Hopper RWKV6 time-mix scan kernel, ``csrc/rwkv6_scan.cu``
(the port of ``repro/kernels/rwkv6_scan/kernel.py::_rwkv_kernel`` and its
``rwkv6_scan`` wrapper, which padded T to a multiple of the chunk: the
CUDA kernel masks the last chunk and takes any T >= 1).

A CUDA tensor launches the kernel (or the wrapper raises); CPU tensors
take the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import rwkv6_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (_P,)
SOURCE = "rwkv6_scan"
HEAD_DIMS = (32, 64)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, *,
               s_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence over T steps, f32 throughout:
    ``y_t = r_t . (S + diag(u) k_t v_t^T)``, ``S <- diag(exp(logw_t)) S +
    k_t v_t^T``.

    r/k/v/logw: (N, T, H, hd) f32; u: (G, H, hd) f32 with G dividing N,
    sequence n reading group n // (N // G) (the ranks of a virtual mesh
    folded into the sequences, each with its own heads' bonus); s0: (N, H,
    hd, hd) f32 or None (zero state).  Returns (y (N, T, H, hd), the final
    state).  The final state goes to ``s_out`` when given, which may be
    ``s0`` itself (an in-place update, the decode path's cache)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)} are not one (N, T, H, hd)")
    N, T, H, hd = r.shape
    state = (N, H, hd, hd)
    if u.dim() != 3 or tuple(u.shape[1:]) != (H, hd) or u.shape[0] < 1 \
            or N % u.shape[0] or T < 1:
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} is not (G, {H}, "
                         f"{hd}) with G dividing N={N}, or T={T} < 1")
    for name, t in (("s0", s0), ("s_out", s_out)):
        if t is not None and tuple(t.shape) != state:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} is not "
                             f"{state}")
    ops = [t for t in (r, k, v, logw, u, s0, s_out) if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        y, s = rwkv6_scan_ref(r, k, v, logw, u, s0)
        return y, s if s_out is None else s_out.copy_(s)
    if r.device.type != "cuda" or any(
            t.device != r.device or t.dtype != torch.float32 for t in ops):
        raise ValueError(
            "rwkv6_scan: expected float32 CUDA tensors on one device, got "
            f"{[(t.dtype, str(t.device)) for t in ops]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {hd} not in {HEAD_DIMS}")
    y = torch.empty_like(r)
    if s_out is None:
        s_out = torch.empty(state, dtype=torch.float32, device=r.device)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in ops + [y, s_out]):
        raise ValueError("rwkv6_scan: operands must be contiguous and "
                         "16-byte aligned")
    fn = _build.c_function(SOURCE, "rwkv6_scan_launch", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), None if s0 is None else s0.data_ptr(),
             y.data_ptr(), s_out.data_ptr(), N, T, H, hd, u.shape[0],
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(SOURCE, "rwkv6_scan", err)
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0

__all__ = ["rwkv6_scan", "rwkv6_scan_ref"]
