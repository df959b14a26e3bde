"""Transformer layers of the dense family over the virtual mesh: the port
of ``repro/models/layers.py`` (the rank-batched picture of its
``shard_map`` code).

Layers are plain functions on tensors.  A parameter group ``p`` is any
mapping of names to tensors (the model's ``nn.ParameterDict``s), each
stacked per rank: (R, *local), R = 1 at tp=1.  Activations carry the same
leading rank axis, (R, B, S, D), and otherwise keep the JAX layouts: q/k/v
(R, B, S, slots, hd), weights ``wq`` (R, D, Q, hd), ``wk``/``wv``
(R, D, U, hd), ``wo`` (R, Q, hd, D).  Projections are matmuls batched over
the ranks (the JAX package left them to XLA); attention runs through the
kernel wrappers in :mod:`repro_torch.kernels` with the ranks folded into
the batch (R*B sequences, each rank's own heads), not through a port of
``attn_core``.  The row-parallel projections (attention ``wo``, MLP
down) are left to the caller: the layers return their inputs (the masked
heads, ``mlp_hidden``) and ``transformer._residual_proj`` projects and
reduces them, overlapped or not.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import hierarchical as hier
from ..core.pcontext import ParallelCtx
from ..kernels import decode_attention, flash_attention, paged_decode_attention
from .common import ModelConfig

Params = Mapping[str, torch.Tensor]
NEG_INF = -1.0e30


def per_rank(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-rank vector w (R, D) shaped to broadcast against x (R, ..., D)."""
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """x (R, ..., D); w (R, D), the norm weight on every rank."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * per_rank(w, x).to(x.dtype)


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
    """x: (R, B, S, N, hd); cos/sin: (B, S, hd/2) or (S, hd/2), the same
    on every rank."""
    half = x.shape[-1] // 2
    cos_, sin_ = cos.unsqueeze(-2), sin.unsqueeze(-2)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, ..., K) @ w (R, K, N) -> (R, ..., N): each rank's activations
    times its own weight shard, one batched product."""
    R, K = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(R, -1, K), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _qkv(p: Params, h: torch.Tensor):
    """h (R, B, S, D) -> q (R, B, S, Q, hd), k/v (R, B, S, U, hd)."""
    def proj(w):
        R, D, n, hd = w.shape
        return rank_matmul(h, w.reshape(R, D, n * hd)) \
            .reshape(*h.shape[:-1], n, hd)
    return proj(p["wq"]), proj(p["wk"]), proj(p["wv"])


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


def _masked_heads(o: torch.Tensor,
                  q_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """o (R, B, S, Q, hd) with dead q slots zeroed: ``q_mask`` (R, Q), as
    the JAX layers' q-mask multiply (``take_local(q_mask_tbl)``); None
    when there are none."""
    if q_mask is None:
        return o
    return o * q_mask[:, None, None, :, None].to(o.dtype)


def _rotated_qkv(p: Params, h: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q, k, v = _qkv(p, h)
    if cfg.rope_theta > 0:
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(R, B, ...) -> (R*B, ...): the ranks as more sequences."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def attention_prefill(p: Params, h: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor,
                      q_mask: Optional[torch.Tensor] = None):
    """Causal full-sequence attention through the flash kernel (the port of
    ``transformer._attention_with_kv``).  h (R, B, S, D); ``positions``
    (S,) are the token positions ``0..S-1`` (the kernel masks by index).
    Returns the masked heads (R, B, S, Q, hd), which the caller projects
    by ``wo`` and reduces (``transformer._residual_proj``; the reference's
    ``project=False``), and the rotated (k, v), (R, B, S, U, hd).  Query
    slot ``s*g + j`` reads kv slot ``s`` (``GQAPlan``), which is the
    kernels' ``h // g``; one launch serves every rank."""
    q, k, v = _rotated_qkv(p, h, cfg, positions)
    o = flash_attention(_fold(q).transpose(1, 2), _fold(k).transpose(1, 2),
                        _fold(v).transpose(1, 2), causal=True,
                        window=cfg.sliding_window).transpose(1, 2)
    return _masked_heads(o.reshape(q.shape), q_mask), (k, v)


def attention_decode(p: Params, h: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                     positions: torch.Tensor, kv_positions: torch.Tensor,
                     q_mask: Optional[torch.Tensor] = None,
                     block_tbl: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode step against this layer's KV cache: the port of
    ``attention_decode`` and ``_attention_decode_paged``.

    h: (R, B, 1, D); positions: (B,) int32 index where the new token is
    written; ``kv_positions`` (R*B,) int32 the same tiled over the ranks.
    Dense: cache['k']/cache['v'] (R*B, S_max, U, hd), rank-major rows.
    Paged (``block_tbl`` (R*B, max_blocks) int32, the table folded over
    the ranks by ``transformer.fold_table``): the physical pool
    (R*n_blocks, bs, U, hd); the new K/V go to block ``block_tbl[b, pos //
    bs]`` at offset ``pos % bs``, and rows of inactive slots point at
    their rank's trash block.

    Unlike the JAX layer, which returns a rebuilt cache, the new K/V are
    written into ``cache`` in place and only the masked heads
    (R, B, 1, Q, hd) are returned, for the caller to project (the
    reference's ``project=False``).
    """
    q, k_new, v_new = _rotated_qkv(p, h, cfg, positions[:, None])
    k, v = cache["k"], cache["v"]
    rb = kv_positions.shape[0]
    bidx = torch.arange(rb, device=h.device)
    pos = kv_positions.long()
    if block_tbl is None:
        rows = (bidx, pos)
    else:
        bs = k.shape[1]
        rows = (block_tbl[bidx, pos // bs].long(), pos % bs)
    k[rows] = _fold(k_new)[:, 0].to(k.dtype)
    v[rows] = _fold(v_new)[:, 0].to(v.dtype)
    qf = _fold(q)[:, 0]
    if block_tbl is None:
        o = decode_attention(qf, k, v, kv_positions,
                             window=cfg.sliding_window)
    else:
        o = paged_decode_attention(qf, k, v, block_tbl, kv_positions,
                                   window=cfg.sliding_window)
    return _masked_heads(o.reshape(q.shape), q_mask)


def mlp_hidden(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Up-projection + activation: the (R, B, S, F_local) input of the
    row-parallel down-projection."""
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"act {cfg.act!r} arrives with ROADMAP item 10 (other families)")
    return F.silu(rank_matmul(h, p["wg"])) * rank_matmul(h, p["wu"])


def mlp_down_w(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The row-sharded down-projection weight ((R, F_local, D))."""
    return p["wd"]


def embed_lookup(p: Params, ids: torch.Tensor, ctx: ParallelCtx, mesh,
                 vocab_pad: int) -> torch.Tensor:
    """Vocab-parallel lookup: local gather (zero rows for ids outside the
    rank's vocab range) + TP reduce (the paper's AR site #0).
    ids (B, S) -> (R, B, S, D)."""
    table = p["tok"]
    R, v_loc = table.shape[0], table.shape[1]
    if v_loc == vocab_pad and not ctx.has_tp:
        return table[:, ids]
    ranks = hier.tp_rank(ctx, mesh, ids.device)
    local = ids[None] - (ranks * v_loc).view(R, *([1] * ids.dim()))
    ok = (local >= 0) & (local < v_loc)
    x = table[ranks.view(R, *([1] * ids.dim())), local.clamp(0, v_loc - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return hier.tp_all_reduce(x, ctx, mesh, scatter_dim=-1)


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Local (vocab-sharded) logits (R, ..., V_local)."""
    head = p["head"] if "head" in p else p["tok"].transpose(-1, -2)
    return rank_matmul(x, head)


def greedy_sample(logits_loc: torch.Tensor, ctx: ParallelCtx, mesh,
                  vocab_real: int) -> torch.Tensor:
    """Greedy next token over vocab-sharded logits (R, B, V_local) ->
    (B,) int32 global ids: the max over the ranks (pmax), then the lowest
    global id among the ranks that hold it (pmin); vocab padding masked."""
    R, _, v_loc = logits_loc.shape
    start = hier.tp_rank(ctx, mesh, logits_loc.device)[:, None] * v_loc
    lf = logits_loc.float()
    gidx = start[..., None] + torch.arange(v_loc, device=lf.device)
    lf = torch.where(gidx < vocab_real, lf,
                     torch.full((), NEG_INF, device=lf.device))
    loc_best = torch.argmax(lf, dim=-1)
    if not ctx.has_tp:
        return loc_best[0].to(torch.int32)
    loc_max = torch.gather(lf, -1, loc_best[..., None])[..., 0]
    gmax = loc_max.max(dim=0).values
    cand = torch.where(loc_max >= gmax, start + loc_best,
                       torch.full((), 2**30, device=lf.device))
    return cand.min(dim=0).values.to(torch.int32)


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer mix (xorshift-multiply), on Python ints or int64
    tensors holding 32-bit values: each product stays below 2**63, so it
    is exact and the same on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def sampling_key(seed: int, rid: int) -> Tuple[int, int]:
    """The base key (two 32-bit words) of request ``rid``'s sampling chain
    under ``seed``: the port's analogue of the reference's
    ``fold_in(PRNGKey(seed), rid)`` (not its numbers)."""
    k0 = _mix32(_mix32(seed & _M32) ^ _mix32((seed >> 32) & _M32)
                ^ (rid & _M32))
    return k0, _mix32(k0 ^ _mix32(((rid >> 32) + 0x6A09E667) & _M32))


def _uniforms(keys: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1) of row b's chain at token ``idx[b]``:
    a counter-based hash of (keys[b], idx[b], vocab index), computed with
    tensor ops on the device, so a row's stream depends on nothing but its
    key and index (no generator state, which a CUDA graph could not
    replay)."""
    k = keys.long()
    row = _mix32(k[:, 0] ^ _mix32(k[:, 1] ^ (idx.long() & _M32)))
    col = _mix32(torch.arange(n, dtype=torch.int64, device=keys.device)
                 + 0x9E3779B9 & _M32)
    h = _mix32(row[:, None] ^ col[None, :])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_token(logits: torch.Tensor, keys: Optional[torch.Tensor] = None,
                 idx: Optional[torch.Tensor] = None, *,
                 temperature: float = 1.0, top_k: int = 0,
                 vocab_real: Optional[int] = None) -> torch.Tensor:
    """Temperature / top-k sampling over full logits (B, V) -> (B,) int32.
    temperature <= 0 is greedy (``keys``/``idx`` unused); vocab padding
    slots are masked.  Row b draws token ``idx[b]`` of its own stateless
    chain ``keys[b]`` ((B, 2) int64, :func:`sampling_key`) by Gumbel-max:
    the argmax of logits / T plus Gumbel noise from :func:`_uniforms`,
    which samples softmax(logits / T) over the top-k.  A stream is
    reproducible from its seed on one device (not equal to the JAX
    package's stream)."""
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
    u = _uniforms(keys, idx, lf.shape[-1])
    return torch.argmax(lf - torch.log(-torch.log(u)), dim=-1) \
        .to(torch.int32)


__all__ = ["rms_norm", "apply_norm", "rope_tables", "apply_rope",
           "rank_matmul", "attention_prefill", "attention_decode",
           "mlp_hidden", "mlp_down_w", "embed_lookup", "lm_logits",
           "greedy_sample", "sample_token", "sampling_key", "NEG_INF"]
