"""Plain PyTorch version of the grouped expert FFN kernel: the port of
``repro/kernels/moe_gemm/ref.py`` (f32 throughout, cast to ``x.dtype`` at
the end), with the kernel's shared-token operand: ``x`` may hold G <= E
token blocks, expert e reading block e // (E // G)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_expert_ffn_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor) -> torch.Tensor:
    """x: (G, C, D), G dividing E; wg/wu: (E, D, F); wd: (E, F, D) ->
    (E, C, D) in x.dtype."""
    E = wg.shape[0]
    xf = x.float()
    if x.shape[0] != E:
        xf = xf.repeat_interleave(E // x.shape[0], dim=0)
    a = torch.bmm(xf, wg.float())
    b = torch.bmm(xf, wu.float())
    return torch.bmm(F.silu(a) * b, wd.float()).to(x.dtype)


__all__ = ["moe_expert_ffn_ref"]
