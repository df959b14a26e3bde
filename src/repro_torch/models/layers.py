"""Transformer layers of the dense family at tp=1: the port of the
single-device path of ``repro/models/layers.py``.

Layers are plain functions on tensors.  A parameter group ``p`` is any
mapping of names to tensors (the model's ``nn.ParameterDict``s).  Shapes
keep the JAX layouts: activations (B, S, D), q/k/v (B, S, slots, hd),
weights ``wq`` (D, Q, hd), ``wk``/``wv`` (D, U, hd), ``wo`` (Q, hd, D).
Attention runs through the kernel wrappers in :mod:`repro_torch.kernels`,
not through a port of ``attn_core``; the projections stay matmuls, as the
JAX package left them to XLA.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, flash_attention, paged_decode_attention
from .common import ModelConfig

Params = Mapping[str, torch.Tensor]
NEG_INF = -1.0e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} arrives with ROADMAP item 10 (other "
            "families)")
    return rms_norm(x, p["w"], cfg.norm_eps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2), f32."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, N, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


def _qkv(p: Params, h: torch.Tensor):
    """h (B, S, D) -> q (B, S, Q, hd), k/v (B, S, U, hd)."""
    q = torch.einsum("bsd,dqh->bsqh", h, p["wq"])
    k = torch.einsum("bsd,duh->bsuh", h, p["wk"])
    v = torch.einsum("bsd,duh->bsuh", h, p["wv"])
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk) of the keys each query may see.  The
    kernels apply this mask themselves; it is kept as the reference the
    tests hold their masking against."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :] if k_pos.dim() == q_pos.dim() else k_pos[None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return m


def _project_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bsqh,qhd->bsd") as one matmul over the flattened heads."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _rotated_qkv(p: Params, h: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q, k, v = _qkv(p, h)
    if cfg.rope_theta > 0:
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_prefill(p: Params, h: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor):
    """Causal full-sequence attention through the flash kernel (the port of
    ``transformer._attention_with_kv``).  ``positions`` (S,) are the token
    positions ``0..S-1`` (the kernel masks by index).  Returns the
    projected output (B, S, D) and the rotated (k, v), (B, S, U, hd).
    Query slot ``s*g + j`` reads kv slot ``s`` (``GQAPlan``), which is the
    kernels' ``h // g``."""
    q, k, v = _rotated_qkv(p, h, cfg, positions)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        window=cfg.sliding_window).transpose(1, 2)
    return _project_out(o, p["wo"]), (k, v)


def attention_decode(p: Params, h: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                     positions: torch.Tensor,
                     block_tbl: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode step against this layer's KV cache: the port of
    ``attention_decode`` and ``_attention_decode_paged``.

    h: (B, 1, D); positions: (B,) int32 index where the new token is
    written.  Dense: cache['k']/cache['v'] (B, S_max, U, hd).  Paged
    (``block_tbl`` (B, max_blocks) int32): the physical pool
    (n_blocks, bs, U, hd); the new K/V go to block ``block_tbl[b, pos //
    bs]`` at offset ``pos % bs``, and rows of inactive slots point at the
    trash block 0.

    Unlike the JAX layer, which returns a rebuilt cache, the new K/V are
    written into ``cache`` in place and only the projected output (B, 1, D)
    is returned.
    """
    q, k_new, v_new = _rotated_qkv(p, h, cfg, positions[:, None])
    k, v = cache["k"], cache["v"]
    bidx = torch.arange(h.shape[0], device=h.device)
    pos = positions.long()
    if block_tbl is None:
        rows = (bidx, pos)
    else:
        bs = k.shape[1]
        rows = (block_tbl[bidx, pos // bs].long(), pos % bs)
    k[rows] = k_new[:, 0].to(k.dtype)
    v[rows] = v_new[:, 0].to(v.dtype)
    if block_tbl is None:
        o = decode_attention(q[:, 0], k, v, positions,
                             window=cfg.sliding_window)
    else:
        o = paged_decode_attention(q[:, 0], k, v, block_tbl, positions,
                                   window=cfg.sliding_window)
    return _project_out(o[:, None], p["wo"])


def mlp_hidden(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Up-projection + activation: the (B, S, F) input of the
    down-projection."""
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"act {cfg.act!r} arrives with ROADMAP item 10 (other families)")
    return F.silu(h @ p["wg"]) * (h @ p["wu"])


def mlp_down_w(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The down-projection weight ((F, D), output last)."""
    return p["wd"]


def mlp(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mlp_hidden(p, h, cfg) @ mlp_down_w(p, cfg)


def embed_lookup(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding at tp=1 (the table holds the whole padded vocab)."""
    return p["tok"][ids]


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    head = p["head"] if "head" in p else p["tok"].T
    return x @ head


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 *, temperature: float = 1.0, top_k: int = 0,
                 vocab_real: Optional[int] = None) -> torch.Tensor:
    """Temperature / top-k sampling over full logits (B, V) -> (B,) int32.
    temperature <= 0 is greedy (``generator`` unused); vocab padding slots
    are masked.  Sampled tokens come from ``generator``, so a stream is
    reproducible from its seed (not equal to the JAX package's stream)."""
    lf = logits.float()
    if vocab_real is not None and vocab_real < lf.shape[-1]:
        keep = torch.arange(lf.shape[-1], device=lf.device) < vocab_real
        lf = torch.where(keep[None, :], lf,
                         torch.full((), NEG_INF, device=lf.device))
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    lf = lf / temperature
    if 0 < top_k < lf.shape[-1]:
        kth = torch.topk(lf, top_k, dim=-1).values[:, -1:]
        lf = torch.where(lf >= kth, lf,
                         torch.full((), NEG_INF, device=lf.device))
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


__all__ = ["rms_norm", "apply_norm", "rope_tables", "apply_rope",
           "attention_prefill", "attention_decode", "mlp", "mlp_hidden",
           "mlp_down_w", "embed_lookup", "lm_logits", "sample_token",
           "NEG_INF"]
