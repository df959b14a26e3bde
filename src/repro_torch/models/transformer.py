"""Model assembly for the dense family at tp=1: parameters, LM forward,
KV caches and the decode step (the port of the single-device path of
``repro/models/transformer.py``).

The model is an ``nn.Module`` (:class:`DenseLM`) holding frozen
parameters in the JAX package's layouts, one :class:`Block` per layer in
an ``nn.ModuleList``; the forward functions are plain functions over it,
with a Python loop over the layers where JAX scanned a stacked pytree.
KV caches are dicts of tensors with a leading layer axis, updated in
place (JAX rebuilt them with ``.at[].set``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from .common import GQAPlan, ModelConfig, dense_init, pad_to, place_heads, \
    plan_gqa

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ArchPlan:
    cfg: ModelConfig
    tp: int
    gqa: GQAPlan
    vocab_pad: int


def make_plan(cfg: ModelConfig, tp: int) -> ArchPlan:
    """The static plan of one (config, tp).  At tp=1 ``plan_gqa`` picks
    g = n_q / n_kv, so the slot layout has no dead q slots and the JAX
    layers' q-mask multiply has nothing to do: the port has none."""
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: tensor parallelism arrives with ROADMAP item 4 (TP "
            "collectives and sharded decode); this slice is tp=1")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP item 10 (other "
            "families); this slice is dense only")
    return ArchPlan(cfg=cfg, tp=tp, gqa=plan_gqa(cfg.n_heads, cfg.n_kv_heads,
                                                 tp),
                    vocab_pad=pad_to(cfg.vocab_size, tp))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _frozen(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class Block(nn.Module):
    """One decoder layer's parameters: ``ln1``, ``attn`` (wq, wk, wv, wo),
    ``ln2``, ``mlp`` (wg, wu, wd)."""

    def __init__(self, tensors: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = _frozen(tensors["ln1"])
        self.attn = _frozen(tensors["attn"])
        self.ln2 = _frozen(tensors["ln2"])
        self.mlp = _frozen(tensors["mlp"])


class DenseLM(nn.Module):
    """Dense decoder parameters: ``embed`` (tok, head), ``blocks``,
    ``final_norm``.  Built by :func:`init_params` or, from the JAX
    package's parameters, by :func:`repro_torch.models.bridge.params_from_numpy`.
    """

    def __init__(self, embed: Mapping[str, torch.Tensor],
                 blocks: List[Mapping[str, Mapping[str, torch.Tensor]]],
                 final_norm: Mapping[str, torch.Tensor]):
        super().__init__()
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)
        self.final_norm = _frozen(final_norm)


def init_params(ap: ArchPlan, *, seed: int,
                device: torch.device | str) -> DenseLM:
    """The port's own seeded init: the shapes and scales of the JAX
    ``init_params`` (weights Normal(0, 1/fan_in), norms 1), drawn from a
    ``torch.Generator`` on ``device`` (not the JAX package's numbers)."""
    cfg, plan = ap.cfg, ap.gqa
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, hd, dt = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.dtype

    def ones(n):
        return {"w": torch.ones(n, dtype=dt, device=device)}

    def block():
        wq = dense_init(gen, (cfg.n_heads, d, hd), d, dt)
        wk = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wv = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wo = dense_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd, dt)
        attn = {"wq": place_heads(wq, plan.q_map).transpose(0, 1).contiguous(),
                "wk": place_heads(wk, plan.kv_map).transpose(0, 1).contiguous(),
                "wv": place_heads(wv, plan.kv_map).transpose(0, 1).contiguous(),
                "wo": place_heads(wo, plan.q_map)}
        mlp = {"wg": dense_init(gen, (d, f), d, dt),
               "wu": dense_init(gen, (d, f), d, dt),
               "wd": dense_init(gen, (f, d), f, dt)}
        return {"ln1": ones(d), "attn": attn, "ln2": ones(d), "mlp": mlp}

    embed = {"tok": dense_init(gen, (ap.vocab_pad, d), d, dt)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (d, ap.vocab_pad), d, dt)
    return DenseLM(embed, [block() for _ in range(cfg.n_layers)], ones(d))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def block_forward(bp: Block, x: torch.Tensor, ap: ArchPlan, *,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One causal block over the full sequence.  Returns (x, (k, v)) with
    the layer's rotated K/V (B, S, U, hd), the prefill cache seed."""
    cfg = ap.cfg
    h = L.apply_norm(x, bp.ln1, cfg)
    attn_out, kv = L.attention_prefill(bp.attn, h, cfg, positions=positions)
    x = x + attn_out
    x = x + L.mlp(bp.mlp, L.apply_norm(x, bp.ln2, cfg), cfg)
    return x, kv


def forward_lm(model: DenseLM, tokens: torch.Tensor, ap: ArchPlan, *,
               collect_state: bool = False
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """tokens (B, S) -> (logits (B, S, V_pad), states).

    ``states`` (when ``collect_state``) holds the per-layer K/V stacked on
    a leading layer axis, {"k", "v"}: (L, B, S, U, hd), else None.  (The JAX
    function also returns an aux loss and encoder output, which the dense
    family does not have.)
    """
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = L.embed_lookup(model.embed, tokens)
    ks, vs = [], []
    for bp in model.blocks:
        x, (k, v) = block_forward(bp, x, ap, positions=positions)
        if collect_state:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(x, model.final_norm, ap.cfg)
    logits = L.lm_logits(model.embed, x)
    states = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_state else None
    return logits, states


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(ap: ArchPlan, batch: int, s_max: int, *, block_size: int = 0,
               device: torch.device | str) -> Cache:
    """Decode cache, leading layer axis.

    ``block_size=0``: dense K/V (L, batch, s_max, U, hd).  ``block_size>0``:
    paged K/V, a pool of physical blocks (L, n_blocks, block_size, U, hd)
    with n_blocks = batch * s_max/block_size + 1, plus ``block_tbl``
    (batch, s_max/block_size) int32.  Block 0 is the trash block; the table
    starts as the identity mapping from 1, which makes the paged cache hold
    the dense cache's contents block by block.
    """
    cfg = ap.cfg
    u, hd, Ld = ap.gqa.u, cfg.head_dim, cfg.n_layers
    if block_size > 0:
        if s_max % block_size:
            raise ValueError(f"s_max={s_max} is not a multiple of "
                             f"block_size={block_size}")
        max_blocks = s_max // block_size
        n_blocks = batch * max_blocks + 1
        shape = (Ld, n_blocks, block_size, u, hd)
        tbl = 1 + torch.arange(batch * max_blocks, dtype=torch.int32,
                               device=device).reshape(batch, max_blocks)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "block_tbl": tbl}
    shape = (Ld, batch, s_max, u, hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _paged_splice(phys: torch.Tensor, states: torch.Tensor,
                  block_tbl: torch.Tensor) -> None:
    """Scatter prefill K/V states (L, B, S, U, hd) into the physical block
    pool (L, n_blocks, bs, U, hd) through the block table, in place.  The
    trailing partial block is zero-padded; those positions are overwritten
    by decode writes before any unmasked read."""
    Ld, B, S, u, hd = states.shape
    bs = phys.shape[2]
    nb = -(-S // bs)
    upd = states.to(phys.dtype)
    if nb * bs > S:
        upd = torch.nn.functional.pad(upd, (0, 0, 0, 0, 0, nb * bs - S))
    phys[:, block_tbl[:, :nb].long()] = upd.reshape(Ld, B, nb, bs, u, hd)


def seed_cache(cache: Cache, states: Cache) -> Cache:
    """Splice prefill-collected layer states into a decode cache at
    position 0, batch-wide, in place; returns ``cache``.  A paged cache
    (``block_tbl`` present) routes K/V through the block table."""
    if "block_tbl" in cache:
        _paged_splice(cache["k"], states["k"], cache["block_tbl"])
        _paged_splice(cache["v"], states["v"], cache["block_tbl"])
    else:
        S = states["k"].shape[2]
        cache["k"][:, :, :S] = states["k"].to(cache["k"].dtype)
        cache["v"][:, :, :S] = states["v"].to(cache["v"].dtype)
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def block_decode(bp: Block, x: torch.Tensor, cache_l: Cache, ap: ArchPlan,
                 *, positions: torch.Tensor,
                 block_tbl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block, one token.  x: (B, 1, D); cache_l: this layer's {"k",
    "v"} (written in place).  Returns x."""
    cfg = ap.cfg
    h = L.apply_norm(x, bp.ln1, cfg)
    x = x + L.attention_decode(bp.attn, h, cache_l, cfg, positions=positions,
                               block_tbl=block_tbl)
    return x + L.mlp(bp.mlp, L.apply_norm(x, bp.ln2, cfg), cfg)


def decode_step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
                positions: torch.Tensor, ap: ArchPlan
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for the whole batch.

    tokens: (B,) int; positions: (B,) int32 write index.  Returns
    (logits (B, V_pad), cache), the cache updated in place.
    """
    block_tbl = cache.get("block_tbl")
    x = L.embed_lookup(model.embed, tokens[:, None])
    for i, bp in enumerate(model.blocks):
        x = block_decode(bp, x, {"k": cache["k"][i], "v": cache["v"][i]}, ap,
                         positions=positions, block_tbl=block_tbl)
    x = L.apply_norm(x, model.final_norm, ap.cfg)
    return L.lm_logits(model.embed, x)[:, 0], cache


__all__ = ["ArchPlan", "make_plan", "Block", "DenseLM", "init_params",
           "block_forward", "forward_lm", "init_cache", "seed_cache",
           "block_decode", "decode_step"]
