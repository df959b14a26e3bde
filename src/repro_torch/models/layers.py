"""Transformer layers over the virtual mesh: the port of
``repro/models/layers.py`` (the rank-batched picture of its ``shard_map``
code): the norms (RMSNorm, LayerNorm), RoPE, self-attention, the
encoder-decoder's cross-attention, the SwiGLU and gelu MLPs, the
vocab-parallel embedding and sampling.

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
from ..kernels import (decode_attention, flash_attention,
                       flash_attention_chunk, paged_decode_attention,
                       w8_matmul)
from ..kernels.flash_attention.autograd import FlashAttention, needs_grad
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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x (R, ..., D); w, b (R, D).  The reference's roundings: mean and
    variance in f32, the normalized x cast to x's dtype, then ``* w + b``
    in that dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * per_rank(w, x).to(x.dtype) + per_rank(b, x).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    if cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
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


def flat_weight(w, K: int):
    """A weight (R, *c, N) or quantized leaf {q, s} seen as (R, K, N),
    K = prod(c): a view, the {q, s} scale as (R, P)."""
    if isinstance(w, Mapping):
        R = w["q"].shape[0]
        return {"q": w["q"].reshape(R, K, -1), "s": w["s"].reshape(R, -1)}
    return w.reshape(w.shape[0], K, -1)


def rank_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (R, ..., K) @ w (R, K, N) -> (R, ..., N): each rank's activations
    times its own weight shard, one batched product.  A quantized leaf
    {"q" (R, K, N) int8, "s" (R, P) bf16} (``parallel/quant.py`` under
    ``weight_quant``) goes to ``w8_matmul``, which dequantizes in
    registers."""
    R, K = x.shape[0], x.shape[-1]
    if isinstance(w, Mapping):
        fw = flat_weight(w, K)
        out = w8_matmul(x.reshape(R, -1, K).contiguous(), fw["q"], fw["s"])
    else:
        out = torch.bmm(x.reshape(R, -1, K), w)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _proj(p: Params, h: torch.Tensor, w: str, b: str) -> torch.Tensor:
    """h (R, B, S, D) projected by ``p[w]`` (R, D, slots, hd) into heads
    (R, B, S, slots, hd), plus the bias ``p[b]`` ((R, slots, hd), each
    rank's own slots) where the group has one, as the reference adds it."""
    wt = p[w]
    n, hd = (wt["q"] if isinstance(wt, Mapping) else wt).shape[-2:]
    y = rank_matmul(h, flat_weight(wt, h.shape[-1])) \
        .reshape(*h.shape[:-1], n, hd)
    if b not in p:
        return y
    return y + p[b].reshape(p[b].shape[0], *([1] * (y.dim() - 3)), n, hd)


def _qkv(p: Params, h: torch.Tensor):
    """h (R, B, S, D) -> q (R, B, S, Q, hd), k/v (R, B, S, U, hd), with a
    QKV-bias arch's ``bq``/``bk``/``bv``; prefill, decode, chunked prefill
    and verify all project here."""
    return tuple(_proj(p, h, w, b)
                 for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))


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
                      q_mask: Optional[torch.Tensor] = None,
                      causal: bool = True):
    """Full-sequence attention through the flash kernel (the port of
    ``transformer._attention_with_kv``), causal, or with ``causal=False``
    every query over every key (the encoder's self-attention).  h (R, B,
    S, D); ``positions`` (S,) are the token positions ``0..S-1`` (the
    kernel masks by index).
    Returns the masked heads (R, B, S, Q, hd), which the caller projects
    by ``wo`` and reduces (``transformer._residual_proj``; the reference's
    ``project=False``), and the rotated (k, v), (R, B, S, U, hd).  Query
    slot ``s*g + j`` reads kv slot ``s`` (``GQAPlan``), which is the
    kernels' ``h // g``; one launch serves every rank.  Where autograd
    records (training), the call goes through
    :class:`~repro_torch.kernels.flash_attention.autograd.FlashAttention`
    (the kernel forward, a plain backward); elsewhere it is the kernel's
    call alone."""
    q, k, v = _rotated_qkv(p, h, cfg, positions)
    qkv = [_fold(t).transpose(1, 2) for t in (q, k, v)]
    if needs_grad(*qkv):
        o = FlashAttention.apply(*qkv, causal, cfg.sliding_window)
    else:
        o = flash_attention(*qkv, causal=causal, window=cfg.sliding_window)
    return _masked_heads(o.transpose(1, 2).reshape(q.shape), q_mask), (k, v)


def cross_kv(p: Params, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's cross-attention K/V of one layer from the encoder's
    output (R, B, T, D): each (R, B, T, U, hd), no RoPE (folded, they are
    the decode cache's ``enc_k`` / ``enc_v``)."""
    return tuple(_proj(p, enc_out, w, b)
                 for w, b in (("wk", "bk"), ("wv", "bv")))


def cross_attention(p: Params, h: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, *,
                    q_mask: Optional[torch.Tensor] = None,
                    decode: bool = False) -> torch.Tensor:
    """The decoder's cross-attention over the encoder's K/V (the port of
    ``layers.cross_attention``): no RoPE and no mask, every query over all
    T encoder keys.  h (R, B, S, D); ``enc_k``/``enc_v`` (R*B, T, U, hd)
    as :func:`cross_kv` and the cache hold them.  In prefill the queries
    go through kernel 3 non-causal (Sq = S over Skv = T); in decode
    (``decode``, S = 1) through kernel 1, every row at position T - 1.
    Returns the masked heads (R, B, S, Q, hd) for the caller to project by
    ``wo`` and reduce."""
    q = _proj(p, h, "wq", "bq")
    qf = _fold(q)
    if decode:
        seen = torch.full((qf.shape[0],), enc_k.shape[1] - 1,
                          dtype=torch.int32, device=h.device)
        o = decode_attention(qf[:, 0], enc_k, enc_v, seen)
    else:
        o = flash_attention(qf.transpose(1, 2), enc_k.transpose(1, 2),
                            enc_v.transpose(1, 2),
                            causal=False).transpose(1, 2)
    return _masked_heads(o.reshape(q.shape), q_mask)


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K or V (..., hd) -> (int8 payload (..., hd), bf16 scale (...)):
    the reference's per-(position, head) ``q8``, scale = max|t| / 127 (at
    least 1e-30), the payload rounded half to even from the f32 scale and
    clipped to +-127.  The quotients are IEEE divisions by device tensors
    (a CUDA division by a Python scalar multiplies by the reciprocal), so
    the card writes the CPU's bits; device-only, so a captured step can
    replay it."""
    tf = t.float()
    sc = torch.clamp(tf.abs().amax(-1) / torch.full((), 127.0,
                                                    device=t.device),
                     min=1e-30)
    qq = torch.clamp(torch.round(tf / sc[..., None]), -127, 127)
    return qq.to(torch.int8), sc.to(torch.bfloat16)


def attention_decode(p: Params, h: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                     positions: torch.Tensor, kv_positions: torch.Tensor,
                     q_mask: Optional[torch.Tensor] = None,
                     block_tbl: Optional[torch.Tensor] = None,
                     ring: bool = False) -> torch.Tensor:
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

    The int8 cache (``cache['k_scale']``/``['v_scale']`` (R*B, S_max, U)
    bf16 beside int8 K/V, dense only): the new K/V are written as
    :func:`quantize_kv` makes them and kernel 1's int8 form reads them.
    The ring (``ring=True``, S_max = the sliding window W): the write goes
    to slot ``pos % W`` and the kernel sees slots 0 .. min(pos, W - 1)
    with no window, the reference's mask "slot <= pos": every slot written
    holds one of the last W positions.

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
        rows = (bidx, pos % k.shape[1] if ring else pos)
    else:
        bs = k.shape[1]
        rows = (block_tbl[bidx, pos // bs].long(), pos % bs)
    kf, vf = _fold(k_new)[:, 0], _fold(v_new)[:, 0]
    scales = {}
    if "k_scale" in cache:
        scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
        (k[rows], scales["k_scale"][rows]) = quantize_kv(kf)
        (v[rows], scales["v_scale"][rows]) = quantize_kv(vf)
    else:
        k[rows] = kf.to(k.dtype)
        v[rows] = vf.to(v.dtype)
    qf = _fold(q)[:, 0]
    if block_tbl is None:
        if ring:
            seen, window = kv_positions.clamp(max=k.shape[1] - 1), 0
        else:
            seen, window = kv_positions, cfg.sliding_window
        o = decode_attention(qf, k, v, seen, window=window, **scales)
    else:
        o = paged_decode_attention(qf, k, v, block_tbl, kv_positions,
                                   window=cfg.sliding_window)
    return _masked_heads(o.reshape(q.shape), q_mask)


def attention_chunk_step(p: Params, h: torch.Tensor,
                         cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                         positions: torch.Tensor, rows: torch.Tensor,
                         q_mask: Optional[torch.Tensor] = None,
                         block_tbl: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Chunked-prefill attention, the port of ``attention_chunk_step``: C
    tokens of each of N sequences write their K/V into the decode cache,
    then attend causally over everything written so far.

    h: (R, N, C, D); positions: (N, C) int32 write positions, contiguous
    in each row; ``rows`` (R*N,) int32, each folded sequence's row of the
    cache (rank-major, as ``prefill_chunk`` computes them).  Dense:
    cache['k']/['v'] (R*B, S_max, U, hd); a position at or past S_max
    writes the row's last in-range value again at S_max - 1 (the reference
    drops such writes; a duplicate of one value keeps the write
    deterministic).  Paged (``block_tbl`` (R*B, max_blocks), the folded
    table): the pool (R*n_blocks, bs, U, hd); positions at or past S_max
    go to the rank's trash block, never into the row's last live block,
    as the reference routes them.  Pads past a prompt's end are safe by
    the write-ordering invariant.  Then one launch of kernel 3's chunk
    form serves every rank and sequence, its query offsets the rows'
    first positions, read on the device.  Written in place; returns the
    masked heads (R, N, C, Q, hd) for the caller to project."""
    q, k_new, v_new = _rotated_qkv(p, h, cfg, positions)
    k, v = cache["k"], cache["v"]
    R = h.shape[0]
    pos = positions.repeat(R, 1).long()                      # (R*N, C)
    kf, vf = _fold(k_new).to(k.dtype), _fold(v_new).to(v.dtype)
    if block_tbl is None:
        s_max = k.shape[1]
        pw = pos.clamp(max=s_max - 1)
        src = (pw - pos[:, :1]).clamp(min=0)
        idx = src[:, :, None, None].expand(-1, -1, *kf.shape[2:])
        dst = (rows.long()[:, None], pw)
        k[dst] = kf.gather(1, idx)
        v[dst] = vf.gather(1, idx)
        kw = {"rows": rows}
    else:
        bs, mb = k.shape[1], block_tbl.shape[1]
        tbl = block_tbl[rows.long()]
        trash = (torch.arange(pos.shape[0], device=h.device)
                 // (pos.shape[0] // R)) * (k.shape[0] // R)
        blk = tbl.gather(1, (pos // bs).clamp(max=mb - 1)).long()
        blk = torch.where(pos < mb * bs, blk, trash[:, None])
        k[(blk, pos % bs)] = kf
        v[(blk, pos % bs)] = vf
        kw = {"block_tbl": tbl}
    o = flash_attention_chunk(_fold(q).transpose(1, 2), k, v,
                              pos[:, 0].to(torch.int32), window=cfg
                              .sliding_window, **kw).transpose(1, 2)
    return _masked_heads(o.reshape(q.shape), q_mask)


def mlp_hidden(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Up-projection + activation: the (R, B, S, F_local) input of the
    row-parallel down-projection.  SwiGLU, or the gelu MLP: ``(h @ w1) +
    b1`` summed in the activation's dtype, then the tanh form of gelu,
    which is ``jax.nn.gelu``'s default (``F.gelu``'s default is the erf
    form, another function)."""
    if cfg.act == "swiglu":
        return F.silu(rank_matmul(h, p["wg"])) * rank_matmul(h, p["wu"])
    if cfg.act != "gelu":
        raise ValueError(f"unknown act {cfg.act!r}")
    y = rank_matmul(h, p["w1"])
    return F.gelu(y + per_rank(p["b1"], y).to(y.dtype), approximate="tanh")


def mlp_down_w(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The row-sharded down-projection weight ((R, F_local, D)): ``wd``,
    or the gelu MLP's ``w2``."""
    return p["wd"] if cfg.act == "swiglu" else p["w2"]


def embed_lookup(p: Params, ids: torch.Tensor, ctx: ParallelCtx, mesh,
                 vocab_pad: int, *, sp: bool = False) -> torch.Tensor:
    """Vocab-parallel lookup: local gather (zero rows for ids outside the
    rank's vocab range) + TP reduce (the paper's AR site #0).
    ids (B, S) -> (R, B, S, D); with ``sp`` the partials end in
    ``tp_reduce_scatter`` on the sequence instead, (R, B, S / fast, D),
    the sequence-parallel residual's layout.  Without TP axes ids may also
    be per rank, (R, B, S), each rank's own batch (data parallelism)."""
    table = p["tok"]
    R, v_loc = table.shape[0], table.shape[1]
    if ids.dim() == 3:
        if ctx.has_tp or v_loc != vocab_pad:
            raise ValueError("per-rank ids (R, B, S) need an unsharded "
                             "vocab (no TP axes)")
        return table[torch.arange(R, device=ids.device)[:, None, None], ids]
    if v_loc == vocab_pad and not ctx.has_tp:
        return table[:, ids]
    ranks = hier.tp_rank(ctx, mesh, ids.device)
    local = ids[None] - (ranks * v_loc).view(R, *([1] * ids.dim()))
    ok = (local >= 0) & (local < v_loc)
    x = table[ranks.view(R, *([1] * ids.dim())), local.clamp(0, v_loc - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    if sp:
        return hier.tp_reduce_scatter(x, ctx, mesh, dim=1)
    return hier.tp_all_reduce(x, ctx, mesh, scatter_dim=-1)


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Local (vocab-sharded) logits (R, ..., V_local)."""
    head = p["head"] if "head" in p else p["tok"].transpose(-1, -2)
    return rank_matmul(x, head)


def sharded_xent(logits_loc: torch.Tensor, labels: torch.Tensor,
                 ctx: ParallelCtx, mesh, vocab_real: int) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits without gathering the
    vocab (the port of ``layers.sharded_xent``): logits (R, ..., V_local),
    labels global ids (R, ...) or (...) the same on every rank -> (R,) f32,
    each rank's mean NLL over its positions.  Vocab padding (global ids
    >= ``vocab_real``) is masked; the max shift is a constant under
    autograd (the reference's ``_pmax_const``: detached, maxed over the TP
    group), and the exp-sums and the picked logits are summed over the TP
    group.  The reference's final ``dp_psum_mean`` over the batch axes is
    the train step's (``hierarchical.dp_psum_mean``)."""
    R, v_loc = logits_loc.shape[0], logits_loc.shape[-1]
    view = (R,) + (1,) * (logits_loc.dim() - 2)
    start = hier.tp_rank(ctx, mesh, logits_loc.device).expand(R) \
        .view(view) * v_loc
    lf = logits_loc.float()
    tp = hier.axes_size(ctx.tp_axes, mesh) if ctx.has_tp else 1
    if tp * v_loc > vocab_real:
        gidx = start[..., None] + torch.arange(v_loc, device=lf.device)
        lf = torch.where(gidx < vocab_real, lf,
                         torch.full((), NEG_INF, device=lf.device))
    m = lf.detach().amax(-1)
    if ctx.has_tp:
        G = hier._groups(ctx, mesh)
        mg = m.reshape(G, R // G, *m.shape[1:])
        m = mg.amax(1, keepdim=True).expand_as(mg).reshape(m.shape)
    se = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
    local = labels.expand(m.shape) - start
    ok = (local >= 0) & (local < v_loc)
    picked = torch.gather(lf, -1, local.clamp(0, v_loc - 1).long()[..., None])
    picked = torch.where(ok, picked[..., 0], torch.zeros(
        (), device=lf.device))
    if ctx.has_tp:
        se = hier._group_sum(se, ctx, mesh)
        picked = hier._group_sum(picked, ctx, mesh)
    nll = torch.log(se) + m - picked
    return nll.reshape(R, -1).mean(1)


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


__all__ = ["rms_norm", "layer_norm", "apply_norm", "rope_tables",
           "apply_rope", "rank_matmul", "flat_weight", "attention_prefill",
           "cross_kv", "cross_attention",
           "attention_decode", "quantize_kv",
           "attention_chunk_step",
           "mlp_hidden", "mlp_down_w", "embed_lookup", "lm_logits",
           "sharded_xent", "greedy_sample", "sample_token", "sampling_key",
           "NEG_INF"]
