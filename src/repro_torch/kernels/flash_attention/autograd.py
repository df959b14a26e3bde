"""Kernel 3 under autograd: the training path's attention.

The TPU kernel has no backward (the reference differentiates its jnp
attention, ``repro/models/layers.py::attn_core``), so neither does the
Hopper kernel: :class:`FlashAttention`'s forward is the kernel's full form
(``ops.flash_attention``: the CUDA kernel on CUDA tensors, its plain
version on CPU tensors), and its backward recomputes attention from the
saved q, k and v in f32 plain ops, a tile of queries at a time
(:func:`flash_attention_grad`), so the (S x S) scratch stays bounded.
The model takes the Function only where autograd will need it
(:func:`needs_grad`, ``layers.attention_prefill``); under
``torch.no_grad`` / ``inference_mode`` (serving, CUDA graphs) it calls the
kernel alone, with nothing saved.
"""
from __future__ import annotations

import torch

from . import ops
from .ref import NEG_INF

# f32 elements of one tile's scores: B x Hq x (queries) x (keys) <= 2**25,
# 128 MiB for each of the tile's score-sized temporaries.
TILE_ELEMS = 2**25


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, *, causal: bool = True,
                         window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window)`` for the
    output gradient ``do`` (B, Hq, Sq, hd): q (B, Hq, Sq, hd), k/v (B, Hkv,
    Skv, hd), query head h reading kv head h // g.  Per tile of queries:
    the scores s = q k^T / sqrt(hd) masked as the kernel masks them (key j
    visible to query i iff j <= i when causal, and j > i - window), p =
    softmax(s), dp = do v^T, ds = p (dp - rowsum(p dp)); dq = ds k /
    sqrt(hd), and dk, dv (summed over the g query heads of a kv head and
    over the tiles) += ds^T q / sqrt(hd), p^T do, all in f32, each
    gradient cast to its input's dtype.  A causal or windowed tile reads
    only the keys some query of it can see."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    tile = max(1, TILE_ELEMS // max(1, B * Hq * Skv))
    for i0 in range(0, Sq, tile):
        i1 = min(Sq, i0 + tile)
        j0 = max(0, i0 - window + 1) if window > 0 else 0
        j1 = min(Skv, i1) if causal else Skv
        qt = q[:, :, i0:i1].reshape(B, Hkv, g, i1 - i0, hd).float()
        dot = do[:, :, i0:i1].reshape(B, Hkv, g, i1 - i0, hd).float()
        kt, vt = kf[:, :, j0:j1], vf[:, :, j0:j1]
        s = torch.einsum("bugsh,buth->bugst", qt, kt) * scale
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(j0, j1, device=q.device)[None, :]
        mask = torch.ones((i1 - i0, j1 - j0), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp <= qp
        if window > 0:
            mask &= kp > qp - window
        p = torch.softmax(torch.where(mask, s, torch.full(
            (), NEG_INF, device=q.device)), dim=-1)
        dp = torch.einsum("bugsh,buth->bugst", dot, vt)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, :, i0:i1] = torch.einsum("bugst,buth->bugsh", ds, kt) \
            .reshape(B, Hq, i1 - i0, hd) * scale
        dk[:, :, j0:j1] += torch.einsum("bugst,bugsh->buth", ds, qt) * scale
        dv[:, :, j0:j1] += torch.einsum("bugst,bugsh->buth", p, dot)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Kernel 3's full form with the plain backward of
    :func:`flash_attention_grad`; saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_grad(q, k, v, do, causal=ctx.causal,
                                      window=ctx.window), None, None)


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``ts`` here."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


__all__ = ["FlashAttention", "flash_attention_grad", "needs_grad",
           "TILE_ELEMS"]
