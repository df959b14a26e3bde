"""Plain PyTorch versions of the flash-attention kernel (masked softmax, f32
math): the port of ``repro/kernels/flash_attention/ref.py``, and its chunk
form over the decode cache (the attention of the reference's
``layers.attention_chunk_step``)."""
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


def _gather_keys(k: torch.Tensor, *, rows: Optional[torch.Tensor] = None,
                block_tbl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each sequence's logical keys (N, n_keys, U, hd) from the dense
    cache (R, S_max, U, hd) by ``rows`` (N,), or from the paged pool
    (n_blocks, bs, U, hd) through ``block_tbl`` (N, max_blocks)."""
    if block_tbl is None:
        return k[rows.long()]
    N, mb = block_tbl.shape
    return k[block_tbl.long()].reshape(N, mb * k.shape[1], *k.shape[2:])


def flash_attention_chunk_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_offset: torch.Tensor, *,
                              rows: Optional[torch.Tensor] = None,
                              block_tbl: Optional[torch.Tensor] = None,
                              window: int = 0) -> torch.Tensor:
    """q (N, Hq, C, hd), sequence n's queries at absolute positions
    ``q_offset[n] + [0, C)``; its keys gathered from the cache (dense rows
    or the paged table, :func:`_gather_keys`) and masked by absolute
    position: key p is visible iff p <= qpos (and p > qpos - window), as
    the reference's ``attention_chunk_step`` masks them -> (N, Hq, C,
    hd)."""
    N, Hq, C, hd = q.shape
    kk = _gather_keys(k, rows=rows, block_tbl=block_tbl)
    vv = _gather_keys(v, rows=rows, block_tbl=block_tbl)
    Hkv, n_keys = kk.shape[2], kk.shape[1]
    qg = q.reshape(N, Hkv, Hq // Hkv, C, hd).float()
    s = torch.einsum("bugsh,btuh->bugst", qg, kk.float()) * (hd ** -0.5)
    qp = q_offset.long()[:, None] + torch.arange(C, device=q.device)
    kp = torch.arange(n_keys, device=q.device)
    mask = kp[None, None, :] <= qp[:, :, None]
    if window > 0:
        mask &= kp[None, None, :] > qp[:, :, None] - window
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bugst,btuh->bugsh", p, vv.float())
    return o.reshape(N, Hq, C, hd).to(q.dtype)


__all__ = ["flash_attention_ref", "flash_attention_chunk_ref"]
