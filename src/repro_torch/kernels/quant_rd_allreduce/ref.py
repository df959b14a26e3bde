"""Plain PyTorch version of the quantized recursive-doubling all-reduce:
the port's copy of ``repro/core/hierarchical.py::quant_rd_all_reduce``,
the loop of packs, XOR exchanges and unpacks that
``csrc/quant_rd_allreduce.cu`` runs in one launch, and the CPU path of
:mod:`repro_torch.kernels.quant_rd_allreduce.ops`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant_pack.ref import GROUP_CAP, quantize_pack, unpack_dequant

# Elements each rank's message is padded to a multiple of (the int8 group
# cap's multiple that every group width divides).
PAD = 256


def xor_exchange(t: torch.Tensor, axis: int, stride: int) -> torch.Tensor:
    """What every rank receives from its XOR peer along ``axis`` of the
    (P, F, ...) view (``lax.ppermute`` by the reference's ``_xor_perm``)."""
    idx = torch.arange(t.shape[axis], device=t.device) ^ stride
    return t.index_select(axis, idx)


def quant_rd_all_reduce_ref(t: torch.Tensor, axis: int,
                            bits: int) -> torch.Tensor:
    """Recursive doubling over ``axis`` (0 or 1, of size n = 2^k) of t
    (P, F, *s) with a symmetric low-bit exchange: BOTH peers of a step
    requantize, ``acc <- deq(Q(acc)) + deq(Q(acc_peer))``, so the two
    compute one sum and the result is exactly replicated across the axis.
    Each rank's message is padded with zeros to a multiple of ``PAD`` and
    grouped at the cap."""
    n = t.shape[axis]
    P, Fn = t.shape[:2]
    acc = t.reshape(P, Fn, -1).float()
    m = acc.shape[-1]
    pad = (-m) % PAD
    if pad:
        acc = F.pad(acc, (0, pad))
    group = GROUP_CAP[bits]
    step = 1
    while step < n:
        q, s = quantize_pack(acc, bits, group)
        acc = (unpack_dequant(q, s, bits, group)
               + unpack_dequant(xor_exchange(q, axis, step),
                                xor_exchange(s, axis, step), bits, group))
        step <<= 1
    return acc[..., :m].reshape(t.shape).to(t.dtype)


__all__ = ["quant_rd_all_reduce_ref", "xor_exchange", "PAD"]
