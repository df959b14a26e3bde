"""Plain PyTorch version of the group-quantized pack/unpack of the
quantized collectives: the port's own copy of
``repro/kernels/rd_allreduce/quant.py``, the oracle the Pallas kernels of
``quant_kernel.py`` are pinned to bit for bit, and the CPU path of
:mod:`repro_torch.kernels.quant_pack.ops`.

Layout contract (shared with ``csrc/quant_pack.cu``):

- Groups run along the **last** dim only: ``x[..., k*group:(k+1)*group]``
  shares one bf16 scale, never across batch or sequence dims.
- ``scale = max|group| / qmax`` in f32, at least 1e-30 so an all-zero
  group stays exact; ``q = clip(round_half_even(x / scale), -qmax, qmax)``
  with that f32 scale, and only the stored scale is rounded to bf16.  A
  NaN or Inf in a group makes its scale non-finite, so dequantization
  poisons exactly that group (no masking).
- int4 values live in [-7, 7]; adjacent elements ``(2i, 2i+1)`` pack into
  one byte, low nibble first.  Pairs may cross group boundaries.
"""
from __future__ import annotations

from typing import Tuple

import torch

QMAX = {8: 127, 4: 7}
# Default and largest groups (int8 g=128: wire factor 0.508 of bf16;
# int4 g=64: 0.266).
GROUP_CAP = {8: 128, 4: 64}
_EPS = 1e-30


def group_for(n_last: int, bits: int) -> int:
    """Largest power-of-two divisor of ``n_last``, capped per ``bits``:
    groups stay aligned with the 2^k shard splits of the collectives."""
    if n_last <= 0:
        return 1
    return min(n_last & (-n_last), GROUP_CAP[bits])


def wire_factor(bits: int, group: int, dtype_bytes: int = 2) -> float:
    """Quantized wire bytes per full-precision wire byte (payload+scales)."""
    return (bits / 8.0 + 2.0 / group) / dtype_bytes


def packed_width(n_last: int, bits: int) -> int:
    """Byte width of the packed payload for a trailing dim of ``n_last``."""
    if bits == 8:
        return n_last
    assert n_last % 2 == 0, n_last
    return n_last // 2


def quantize_pack(x: torch.Tensor, bits: int,
                  group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (packed int8 (..., Dp), scales bf16 (..., D/group)).

    Requires D % group == 0 and, for int4, D even (callers pad)."""
    qmax = QMAX[bits]
    D = x.shape[-1]
    assert D % group == 0, (D, group)
    g = x.float().reshape(*x.shape[:-1], D // group, group)
    absmax = g.abs().amax(-1)                    # NaN propagates
    # qmax as a tensor on x's device: PyTorch's CUDA division by a Python
    # (CPU) scalar multiplies by its reciprocal, which is not the IEEE
    # quotient the contract (and the kernel) takes.
    scale = torch.maximum(
        absmax / torch.tensor(float(qmax), device=x.device),
        torch.tensor(_EPS, device=x.device))
    q = torch.round(g / scale[..., None]).clamp(-qmax, qmax)
    q = q.to(torch.int32).reshape(*x.shape[:-1], D)
    if bits == 4:
        assert D % 2 == 0, D
        pairs = q.reshape(*x.shape[:-1], D // 2, 2)
        q = (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)
        return q.to(torch.uint8).view(torch.int8), scale.to(torch.bfloat16)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def unpack_dequant(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                   group: int) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`; returns f32 (..., D)."""
    if bits == 4:
        v = packed.to(torch.int32) & 0xFF
        lo, hi = v & 0xF, (v >> 4) & 0xF
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        q = torch.stack([lo, hi], dim=-1).reshape(
            *packed.shape[:-1], packed.shape[-1] * 2)
    else:
        q = packed
    D = q.shape[-1]
    assert D % group == 0, (D, group)
    g = q.reshape(*q.shape[:-1], D // group, group).float()
    return (g * scales.float()[..., None]).reshape(*q.shape[:-1], D)


def quantize_pack_err(x: torch.Tensor, bits: int, group: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quantize_pack` and the f32 rounding residue of the same
    call, ``x - unpack_dequant(q, s)`` (the error feedback of the
    reduce-scatter), which the kernel writes in the same pass."""
    q, s = quantize_pack(x, bits, group)
    return q, s, x.float() - unpack_dequant(q, s, bits, group)


def unpack_dequant_sum(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                       group: int, piece_dim: int) -> torch.Tensor:
    """:func:`unpack_dequant` of every piece along ``piece_dim`` (a dim of
    the payload other than the last), summed in index order, one f32
    rounding a term: the kernel's order, so the two agree bitwise."""
    parts = unpack_dequant(packed, scales, bits, group).unbind(piece_dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


__all__ = ["QMAX", "GROUP_CAP", "group_for", "wire_factor", "packed_width",
           "quantize_pack", "quantize_pack_err", "unpack_dequant",
           "unpack_dequant_sum"]
