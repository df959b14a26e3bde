"""Plain PyTorch versions of the grouped expert FFN kernel, with the
kernel's shared-token operand: ``x`` may hold G <= E token blocks, expert
e reading block e // (E // G).

``moe_expert_ffn_ref`` is the port of ``repro/kernels/moe_gemm/ref.py``
(f32 throughout, cast to ``x.dtype`` at the end): the CPU path and the
oracle.  ``moe_expert_ffn_split_ref`` is the bf16 kernel's arithmetic:
F in slices of ``SLICE_F``, h of a slice rounded to the operand type, the
slices' f32 down products summed in ascending order."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# F rows a slice of the bf16 kernel (csrc/moe_gemm.cu kFS).
SLICE_F = 256


def _expert_blocks(x: torch.Tensor, E: int) -> torch.Tensor:
    xf = x.float()
    return xf if x.shape[0] == E else \
        xf.repeat_interleave(E // x.shape[0], dim=0)


def moe_expert_ffn_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor) -> torch.Tensor:
    """x: (G, C, D), G dividing E; wg/wu: (E, D, F); wd: (E, F, D) ->
    (E, C, D) in x.dtype."""
    xf = _expert_blocks(x, wg.shape[0])
    a = torch.bmm(xf, wg.float())
    b = torch.bmm(xf, wu.float())
    return torch.bmm(F.silu(a) * b, wd.float()).to(x.dtype)


def moe_expert_ffn_split_ref(x: torch.Tensor, wg: torch.Tensor,
                             wu: torch.Tensor, wd: torch.Tensor, *,
                             slice_f: int = SLICE_F) -> torch.Tensor:
    """As :func:`moe_expert_ffn_ref`, in the bf16 kernel's order: for
    each slice of ``slice_f`` columns of F, the gate and up sums in f32,
    h = silu(g) * u rounded to ``x.dtype`` (no rounding in f32), and the
    slice's down product in f32; the partials summed in ascending slice
    order, rounded once to ``x.dtype``."""
    xf = _expert_blocks(x, wg.shape[0])
    out = None
    for f0 in range(0, wg.shape[2], slice_f):
        sl = slice(f0, f0 + slice_f)
        h = F.silu(torch.bmm(xf, wg[:, :, sl].float())) \
            * torch.bmm(xf, wu[:, :, sl].float())
        part = torch.bmm(h.to(x.dtype).float(), wd[:, sl].float())
        out = part if out is None else out + part
    return out.to(x.dtype)


__all__ = ["moe_expert_ffn_ref", "moe_expert_ffn_split_ref", "SLICE_F"]
