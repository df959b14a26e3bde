"""Wrapper of the Hopper grouped expert FFN kernel, ``csrc/moe_gemm.cu``
(the port of ``repro/kernels/moe_gemm/kernel.py::_moe_ffn_kernel`` and its
``moe_expert_ffn`` wrapper, which padded C and F to 128-multiples: the
CUDA kernel masks its remainders and takes the shapes as they are).

A CUDA tensor launches the kernel (or the wrapper raises); CPU tensors
take the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._checks import DTYPES
from .ref import moe_expert_ffn_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 8 + (_P,)
SOURCE = "moe_gemm"
# Dynamic shared memory one CTA may take on an H100 (hopper-kernels §1).
MAX_SMEM = 232448
# csrc/moe_gemm.cu: token rows a CTA, and the shared memory of the
# one-launch kernel besides its (kBC, D) f32 accumulator and token rows
# (the gate/up partial sums and the h tile).
KBC = 8
SMEM_FIXED = (2 * 4 * KBC * 64 + KBC * 64) * 4
# D columns a CTA computes when all of D does not fit: the kernel's
# 2048-column down pass (kDownCols), so both forms sum in one order.
D_TILE = 2048


def smem_bytes(D: int, esz: int) -> int:
    """Dynamic shared memory of one CTA of the one-launch kernel at this
    d_model (``smem_bytes`` in the source)."""
    return KBC * D * (4 + esz) + SMEM_FIXED


def d_tile(D: int, esz: int) -> int:
    """D columns one CTA computes: all of D while the one-launch kernel
    fits one CTA's shared memory, else ``D_TILE`` (the two-launch form,
    which stages h in an f32 scratch)."""
    return D if smem_bytes(D, esz) <= MAX_SMEM else D_TILE


def moe_expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """out[e, c] = (silu(x[g(e), c] @ wg[e]) * (x[g(e), c] @ wu[e])) @ wd[e]
    with f32 sums, in x.dtype.

    x: (G, C, D) with G dividing E: expert e reads token block
    g(e) = e // (E // G) (G == E: one block per expert, the dispatch path;
    G < E: a block shared by E / G experts, the decode path, without E
    copies); wg/wu: (E, D, F); wd: (E, F, D) -> (E, C, D).  Any D: on
    CUDA, :func:`d_tile` picks the kernel's form, which never changes the
    result."""
    if x.dim() != 3 or wg.dim() != 3 or wu.shape != wg.shape \
            or wd.dim() != 3:
        raise ValueError(f"moe_expert_ffn: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)} are not (G, C, D), (E, D, F), "
                         "(E, D, F), (E, F, D)")
    G, C, D = x.shape
    E, _, Fh = wg.shape
    if wg.shape[1] != D or wd.shape != (E, Fh, D) or G < 1 or E % G:
        raise ValueError(f"moe_expert_ffn: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wd {tuple(wd.shape)}: D, F or "
                         "the expert groups do not match")
    ops = (x, wg, wu, wd)
    if all(t.device.type == "cpu" for t in ops):
        return moe_expert_ffn_ref(x, wg, wu, wd)
    if x.device.type != "cuda" or x.dtype not in DTYPES \
            or any(t.device != x.device or t.dtype != x.dtype for t in ops):
        raise ValueError(
            "moe_expert_ffn: expected CUDA tensors of one dtype in "
            f"{DTYPES}, got {[(t.dtype, str(t.device)) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("moe_expert_ffn: operands must be contiguous")
    is_bf16 = int(x.dtype == torch.bfloat16)
    dt = d_tile(D, x.element_size())
    out = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    h = torch.empty((E, C, Fh) if dt < D else (0,), dtype=torch.float32,
                    device=x.device)
    vec = int(D % 8 == 0 and Fh % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in ops + (out,)))
    fn = _build.c_function(SOURCE, "moe_ffn_launch", _ARGTYPES)
    err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
             out.data_ptr(), h.data_ptr(), E, C, D, Fh, G, dt, is_bf16, vec,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(SOURCE, "moe_expert_ffn", err)
    moe_expert_ffn.launches += 1
    return out


moe_expert_ffn.launches = 0

__all__ = ["moe_expert_ffn", "moe_expert_ffn_ref", "d_tile", "smem_bytes",
           "D_TILE"]
