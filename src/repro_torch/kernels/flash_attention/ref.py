"""Plain PyTorch version of the flash-attention kernel (masked softmax, f32
math): the port of ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd).  GQA by head grouping:
    query head h reads kv head h // (Hq // Hkv)."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, hd).float()
    s = torch.einsum("bugsh,buth->bugst", qg, k.float()) * (hd ** -0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= kp < kv_len
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bugst,buth->bugsh", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)


__all__ = ["flash_attention_ref"]
