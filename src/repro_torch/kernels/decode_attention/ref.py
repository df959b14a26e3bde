"""Plain PyTorch version of the decode-attention kernels: the port of
``repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd); positions: (B,)."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = torch.einsum("bugh,bsuh->bugs", qg, k.float()) * (hd ** -0.5)
    kp = torch.arange(S, device=q.device)[None, :]
    pos = positions.long()[:, None]
    mask = kp <= pos
    if window > 0:
        mask &= kp > pos - window
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bugs,bsuh->bugh", p, v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_phys: torch.Tensor,
                               v_phys: torch.Tensor, block_tbl: torch.Tensor,
                               positions: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """Gather the logical K/V view through the block table, then run the
    dense version.  k_phys/v_phys: (n_blocks, bs, Hkv, hd);
    block_tbl: (B, max_blocks) int32."""
    B = q.shape[0]
    mb, bs = block_tbl.shape[1], k_phys.shape[1]
    Hkv, hd = k_phys.shape[2], k_phys.shape[3]
    tbl = block_tbl.long()
    k = k_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    v = v_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    return decode_attention_ref(q, k, v, positions, window=window)


__all__ = ["decode_attention_ref", "paged_decode_attention_ref"]
