"""Model assembly for the dense, MoE, ssm (RWKV6) and hybrid (Hymba)
families: parameters, LM forward, caches and the decode step, at tp=1 and
over the virtual mesh (the port of ``repro/models/transformer.py``).

The model is an ``nn.Module`` (:class:`DenseLM`) holding frozen
parameters in the JAX package's layouts, each stacked per rank
(R, *local), R = 1 at tp=1; one :class:`Block` per layer in an
``nn.ModuleList``.  The forward functions are plain functions over it,
with a Python loop over the layers where JAX scanned a stacked pytree, and
one code path for every tp: activations carry the rank axis, each layer's
two row-parallel projections go through ``_residual_proj`` (their partial
sums reduced by ``tp_all_reduce``, or with ``ctx.overlap_matmul`` the
projection and its reduction overlapped in ``core/overlap.py``), and the
vocab-parallel embedding through ``tp_all_reduce``.  A MoE block
(``models/moe.py``) replaces the MLP: in prefill each rank dispatches its
own chunk of the sequence through the EP all-to-all and the outputs are
gathered back (``_moe_tokens``/``_moe_restore``); in decode every rank
runs its local experts on all tokens and ``tp_all_reduce`` (the paper's
collective) completes the combine.  Attention ``wo`` keeps
``_residual_proj`` in both families.  An ssm block (``models/rwkv.py``)
has no attention: its time-mix output and its stacked channel-mix partial
each take one ``tp_all_reduce`` (never overlapped, as in the reference),
and its cache is the recurrent state (token shifts and the wkv state, no
K/V).  A hybrid block (``models/ssm.py``) runs attention and a Mamba-style
selective-state-space mixer side by side on the same normed input: the
attention heads are projected by ``wo`` without a reduction, mixed with
the mixer's TP-partial output by ``beta``, and the mix takes ONE
``tp_all_reduce`` (never overlapped, as in the reference); its MLP goes
through ``_residual_proj`` as the dense family's; its cache holds the K/V
(dense or paged) and the recurrent ``conv``/``ssm`` leaves.  Caches are
dicts of tensors with a leading layer axis and the ranks folded into the
batch, updated in place (JAX rebuilt them with ``.at[].set``).  Under a
quantized wire (``ctx.ar_quant`` other than "none") the decode cache also
carries the error-feedback leaf ``ef`` (:func:`ef_sites_for`), which the
two row-parallel reductions of every decode block consume and refresh;
prefill takes the one-shot rounding.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import hierarchical as hier
from ..core import overlap as ov
from ..core.pcontext import LOCAL, ParallelCtx
from ..parallel.sharding import shard_params
from . import layers as L
from . import moe as M
from . import rwkv as RW
from . import ssm as SSM
from .common import GQAPlan, ModelConfig, dense_init, pad_to, place_heads, \
    plan_gqa

Cache = Dict[str, torch.Tensor]
# The recurrent per-layer cache leaves, batch-indexed under paging too: the
# ssm family's (no K/V) and the hybrid family's mamba state (beside K/V).
RECURRENT_LEAVES = ("shift_tm", "shift_cm", "wkv", "conv", "ssm")


@dataclasses.dataclass(frozen=True)
class ArchPlan:
    cfg: ModelConfig
    tp: int
    gqa: Optional[GQAPlan]       # None for the attention-free ssm family
    vocab_pad: int

    @property
    def q_mask_tbl(self) -> Optional[np.ndarray]:
        """(tp, q slots per rank) live-slot mask, or None when no slot is
        dead (then the layers skip the multiply) or there is no
        attention."""
        if self.gqa is None:
            return None
        m = self.gqa.q_mask().reshape(self.tp, self.gqa.q_slots_local)
        return None if m.min() >= 1.0 else m

    @property
    def rwkv_heads_local(self) -> int:
        return self.cfg.d_model // self.cfg.rwkv_head_dim // self.tp

    @property
    def d_inner_local(self) -> int:
        return self.cfg.d_inner // self.tp


def make_plan(cfg: ModelConfig, tp: int) -> ArchPlan:
    """The static plan of one (config, tp).  At tp=1 ``plan_gqa`` picks
    g = n_q / n_kv and no slot is dead; at tp > 1 a plan can have dead
    slots, which carry zero weights and are masked after attention.  As
    in the reference, a MoE plan skips the width checks (its FFN is cut
    on the expert axis); it is refused when tp does not divide the
    experts, which the reference would replicate while its MoE layer
    slices them.  An ssm plan has no GQA plan; it is refused when tp does
    not divide its heads (d_model / rwkv_head_dim), which the reference
    would replicate while its state is cut by heads.  A hybrid plan is the
    dense GQA plan; it is refused when tp does not divide d_inner, which
    the reference does not check (ROADMAP §3)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP item 10 (other "
            "families); the port runs the dense, MoE, ssm and hybrid "
            "families")
    for dim, name in ((cfg.d_model, "d_model"), (cfg.d_ff, "d_ff")):
        if cfg.family != "moe" and dim % tp:
            raise ValueError(f"{cfg.name}: {name}={dim} not divisible by "
                             f"tp={tp}")
    if cfg.family == "moe" and (not cfg.is_moe or cfg.n_experts % tp):
        raise ValueError(f"{cfg.name}: n_experts={cfg.n_experts} not "
                         f"divisible by tp={tp}")
    heads = cfg.d_model // cfg.rwkv_head_dim
    if cfg.attn_free and (cfg.d_model % cfg.rwkv_head_dim or heads % tp):
        raise ValueError(f"{cfg.name}: {heads} heads of {cfg.rwkv_head_dim} "
                         f"not divisible by tp={tp}")
    if cfg.family == "hybrid" and cfg.d_inner % tp:
        raise ValueError(f"{cfg.name}: d_inner={cfg.d_inner} not divisible "
                         f"by tp={tp}")
    gqa = None if cfg.attn_free else plan_gqa(cfg.n_heads, cfg.n_kv_heads,
                                              tp)
    return ArchPlan(cfg=cfg, tp=tp, gqa=gqa,
                    vocab_pad=pad_to(cfg.vocab_size, tp))


def check_layout(ap: ArchPlan, ctx: ParallelCtx, mesh) -> int:
    """Raise unless (ap, ctx, mesh) describe one layout; returns R."""
    if ctx.dp or ctx.fsdp or ctx.sp:
        raise NotImplementedError(
            f"ctx dp={ctx.dp} fsdp={ctx.fsdp} sp={ctx.sp}: the virtual mesh "
            "holds the TP axes only; batch- and weight-sharded serving "
            "arrive with ROADMAP item 11, sequence-parallel residuals with "
            "item 9")
    if mesh is None:
        if ctx.has_tp or ap.tp != 1:
            raise ValueError(f"tp={ap.tp} with TP axes {ctx.tp_axes} needs "
                             "a VirtualMesh")
        return 1
    mesh.check_ctx(ctx)
    if mesh.size != ap.tp:
        raise ValueError(f"plan tp={ap.tp} on a mesh of {mesh.size} ranks")
    return mesh.size


@functools.lru_cache(maxsize=64)
def _q_mask(ap: ArchPlan, device: torch.device) -> Optional[torch.Tensor]:
    """The plan's live-slot mask on ``device``, made once (a host-to-device
    copy, which a captured decode step must not contain)."""
    tbl = ap.q_mask_tbl
    return None if tbl is None else torch.as_tensor(tbl, device=device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _frozen(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class Block(nn.Module):
    """One decoder layer's parameter groups, each (R, *local): ``ln1``,
    ``attn`` (wq, wk, wv, wo), ``ln2``, and either ``mlp`` (wg, wu, wd) or
    ``moe`` (router f32; wg, wu, wd cut on the expert axis); a hybrid
    block adds ``ssm`` (the mamba mixer) and ``beta``, a bare (R, 2) f32
    tensor; or, for the ssm family, ``ln1``, ``tm`` (the RWKV6 time-mix),
    ``ln2``, ``cm`` (the channel-mix)."""

    def __init__(self, tensors: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        for name, group in tensors.items():
            setattr(self, name, nn.Parameter(group, requires_grad=False)
                    if isinstance(group, torch.Tensor) else _frozen(group))


class DenseLM(nn.Module):
    """A decoder of any ported family (dense MLP, MoE, RWKV6, hybrid):
    ``embed`` (tok, head), ``blocks``, ``final_norm``, every leaf stacked
    per rank.
    Built by :func:`init_params` or, from the JAX package's parameters, by
    :func:`repro_torch.models.bridge.params_from_numpy`.
    """

    def __init__(self, embed: Mapping[str, torch.Tensor],
                 blocks: List[Mapping[str, Mapping[str, torch.Tensor]]],
                 final_norm: Mapping[str, torch.Tensor]):
        super().__init__()
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)
        self.final_norm = _frozen(final_norm)

    @property
    def n_ranks(self) -> int:
        return self.embed["tok"].shape[0]


def from_global(tree: Mapping, mesh=None) -> DenseLM:
    """A DenseLM from a global-layout tree {"embed", "blocks" (a list of
    per-layer groups), "final_norm"}, cut over the mesh's ranks."""
    t = shard_params(tree, mesh)
    return DenseLM(t["embed"], t["blocks"], t["final_norm"])


def init_params(ap: ArchPlan, *, seed: int, device: torch.device | str,
                mesh=None) -> DenseLM:
    """The port's own seeded init: the shapes and scales of the JAX
    ``init_params`` at ``ap.tp`` (weights Normal(0, 1/fan_in) in the
    plan's slot layout, norms 1, a MoE router in f32; the RWKV6 groups
    of ``rwkv.init_rwkv_*``; the mamba group of ``ssm.init_ssm`` and
    ``beta`` ones in f32), drawn from a ``torch.Generator`` on ``device``
    (not the JAX package's numbers), then cut over ``mesh`` (R = ap.tp
    ranks) one layer at a time, so the global and the cut copy of the
    whole model are never both held.  Every draw has a shape that does not
    depend on tp: the attention weights are drawn per original head and
    then placed into the plan's slots (dead slots zero), and ``tok``/
    ``head`` are drawn at the real vocab and zero-padded to the plan's
    ``vocab_pad``.  So one seed gives one function at every tp, dead slots
    and vocab padding included."""
    cfg, plan = ap.cfg, ap.gqa
    if (mesh.size if mesh is not None else 1) != ap.tp:
        raise ValueError(f"plan tp={ap.tp} on {mesh}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, hd, dt = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.dtype

    def ones(n):
        return {"w": torch.ones(n, dtype=dt, device=device)}

    def block():
        if cfg.attn_free:
            return shard_params({"ln1": ones(d),
                                 "tm": RW.init_rwkv_time_mix(gen, cfg),
                                 "ln2": ones(d),
                                 "cm": RW.init_rwkv_channel_mix(gen, cfg)},
                                mesh)
        wq = dense_init(gen, (cfg.n_heads, d, hd), d, dt)
        wk = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wv = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wo = dense_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd, dt)
        attn = {"wq": place_heads(wq, plan.q_map).transpose(0, 1).contiguous(),
                "wk": place_heads(wk, plan.kv_map).transpose(0, 1).contiguous(),
                "wv": place_heads(wv, plan.kv_map).transpose(0, 1).contiguous(),
                "wo": place_heads(wo, plan.q_map)}
        blk = {"ln1": ones(d), "attn": attn, "ln2": ones(d)}
        if cfg.family == "hybrid":
            blk["ssm"] = SSM.init_ssm(gen, cfg)
            blk["beta"] = torch.ones(2, dtype=torch.float32, device=device)
        if cfg.is_moe:
            blk["moe"] = M.init_moe(gen, cfg)
        else:
            blk["mlp"] = {"wg": dense_init(gen, (d, f), d, dt),
                          "wu": dense_init(gen, (d, f), d, dt),
                          "wd": dense_init(gen, (f, d), f, dt)}
        return shard_params(blk, mesh)

    pad = ap.vocab_pad - cfg.vocab_size
    embed = {"tok": torch.nn.functional.pad(
        dense_init(gen, (cfg.vocab_size, d), d, dt), (0, 0, 0, pad))}
    if not cfg.tie_embeddings:
        embed["head"] = torch.nn.functional.pad(
            dense_init(gen, (d, cfg.vocab_size), d, dt), (0, pad))
    embed = shard_params(embed, mesh)
    blocks = [block() for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, shard_params(ones(d), mesh))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _use_overlap(ctx: ParallelCtx) -> bool:
    """Route the row-parallel output projections through the overlapped
    collective matmul."""
    return ctx.overlap_matmul and ctx.has_tp


def _residual_proj(x: torch.Tensor, lhs: torch.Tensor, w: torch.Tensor,
                   ctx: ParallelCtx, mesh, ef: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x plus the TP-reduced projection of ``lhs`` (the pre-projection
    activation, (R, B, S, *c)) by the row-sharded ``w`` ((R, *c, D)), the
    new error-feedback residue): overlapped when the ctx asks for it, else
    the projection then ``tp_all_reduce``.  ``ef`` (R, B, S, D) is this
    site's residue (None: no EF, and None comes back)."""
    if _use_overlap(ctx):
        y = ov.collective_matmul(lhs, w, ctx, mesh, ef=ef)
    else:
        y = hier.tp_all_reduce(ov.project(lhs, w), ctx, mesh, scatter_dim=-1,
                               ef=ef)
    y, ef = y if ef is not None else (y, None)
    return x + y, ef


def _moe_tokens(h: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """MoE consumes per-rank-unique tokens: rank r takes the r-th
    contiguous chunk of the sequence of h (R, B, S, D) (no exchange)."""
    if not ctx.has_tp:
        return h
    R, B, S, D = h.shape
    if S % R:
        raise ValueError(f"sequence {S} is not divisible by tp={R}: the MoE "
                         "dispatch gives every rank S/tp of its tokens")
    r = torch.arange(R, device=h.device)
    return h.reshape(R, B, R, S // R, D)[r, :, r]


def _moe_restore(out: torch.Tensor, ctx: ParallelCtx, mesh) -> torch.Tensor:
    """The ranks' sequence chunks gathered back to the full sequence."""
    return hier.all_gather_tiled(out, ctx, mesh, dim=1)


def _cm_residual(x: torch.Tensor, stacked: torch.Tensor, ctx: ParallelCtx,
                 mesh) -> torch.Tensor:
    """x plus the gated channel-mix: the stacked (value, receptance logit)
    partial (R, 2, B, S, D) completed by one ``tp_all_reduce``, then
    ``sigmoid(r) * v``."""
    red = hier.tp_all_reduce(stacked, ctx, mesh, scatter_dim=-1)
    return x + torch.sigmoid(red[:, 1].float()).to(x.dtype) * red[:, 0]


def _mixed_residual(x: torch.Tensor, beta: torch.Tensor, attn: torch.Tensor,
                    ssm: torch.Tensor, ctx: ParallelCtx, mesh) -> torch.Tensor:
    """x plus the hybrid block's mix: ``beta`` (R, 2) f32 cast to the
    activation dtype, as the reference casts it, ``beta0 * attn + beta1 *
    ssm`` over the two TP-partial outputs (R, B, S, D), completed by one
    ``tp_all_reduce``."""
    b = beta.to(attn.dtype)
    mix = L.per_rank(b[:, :1], attn) * attn + L.per_rank(b[:, 1:], ssm) * ssm
    return x + hier.tp_all_reduce(mix, ctx, mesh, scatter_dim=-1)


def block_forward(bp: Block, x: torch.Tensor, ap: ArchPlan,
                  ctx: ParallelCtx = LOCAL, mesh=None, *,
                  positions: torch.Tensor,
                  q_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    """One causal block over the full sequence, x (R, B, S, D) replicated.
    Returns (x, the layer's prefill cache seed): the rotated K/V {"k",
    "v"} (R, B, S, U, hd), for a hybrid block with the mamba state
    {"conv"} (R, B, K-1, Ci) and {"ssm"} (R, B, Ci, s) beside them, or for
    an ssm block the recurrent state {"shift_tm", "shift_cm"} (R, B, D)
    and {"wkv"} (R, B, H, hd, hd).  The row-parallel projections go
    through ``_residual_proj`` (no SP), except a hybrid block's attention
    ``wo``, whose partial is mixed with the mamba mixer's before its one
    reduction (``_mixed_residual``); a MoE block runs the dispatch path on
    each rank's chunk of the sequence and gathers the outputs back (its
    load-balancing loss, which only training reads, is dropped)."""
    cfg = ap.cfg
    h = L.apply_norm(x, bp.ln1, cfg)
    if cfg.attn_free:
        tm, st = RW.rwkv_time_mix(bp.tm, h, cfg, return_state=True)
        x = x + hier.tp_all_reduce(tm, ctx, mesh, scatter_dim=-1)
        h2 = L.apply_norm(x, bp.ln2, cfg)
        stacked, st2 = RW.rwkv_channel_mix(bp.cm, h2, cfg, return_state=True)
        st["wkv"] = st["wkv"].reshape(*x.shape[:2], *st["wkv"].shape[1:])
        return _cm_residual(x, stacked, ctx, mesh), {**st, **st2}
    heads, kv = L.attention_prefill(bp.attn, h, cfg, positions=positions,
                                    q_mask=q_mask)
    st = {"k": kv[0], "v": kv[1]}
    if cfg.family == "hybrid":
        so, sst = SSM.ssm_mixer(bp.ssm, h, cfg, return_state=True)
        st["conv"] = sst["conv"]
        st["ssm"] = sst["ssm"].reshape(*x.shape[:2], *sst["ssm"].shape[1:])
        x = _mixed_residual(x, bp.beta, ov.project(heads, bp.attn["wo"]), so,
                            ctx, mesh)
    else:
        x, _ = _residual_proj(x, heads, bp.attn["wo"], ctx, mesh)
    h2 = L.apply_norm(x, bp.ln2, cfg)
    if cfg.is_moe:
        out, _ = M.moe_ffn(bp.moe, _moe_tokens(h2, ctx), cfg, ctx, mesh,
                           decode=False)
        return x + _moe_restore(out, ctx, mesh), st
    x, _ = _residual_proj(x, L.mlp_hidden(bp.mlp, h2, cfg),
                          L.mlp_down_w(bp.mlp, cfg), ctx, mesh)
    return x, st


def _unranked(t: torch.Tensor, mesh) -> torch.Tensor:
    """Public outputs keep the reference's layouts: without a mesh (tp=1)
    the rank axis of size 1 is dropped."""
    return t if mesh is not None else t[0]


def forward_lm(model: DenseLM, tokens: torch.Tensor, ap: ArchPlan,
               ctx: ParallelCtx = LOCAL, mesh=None, *,
               collect_state: bool = False
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """tokens (B, S) -> (logits, states).

    ``logits`` are vocab-sharded, (R, B, S, V_local), on a mesh and
    (B, S, V_pad) without one.  ``states`` (when ``collect_state``) hold
    the per-layer cache seeds stacked on a leading layer axis, the ranks
    folded into the batch as in the cache: {"k", "v"} (L, R*B, S, U, hd),
    for the hybrid family with {"conv"} (L, R*B, K-1, Ci) and {"ssm"}
    (L, R*B, Ci, s) beside them, or for the ssm family {"shift_tm",
    "shift_cm"} (L, R*B, D) and {"wkv"} (L, R*B, H, hd, hd); else None.
    (The JAX function also returns the MoE load-balancing loss, which only
    training reads, and an encoder output, which no family here has.)
    """
    check_layout(ap, ctx, mesh)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    q_mask = _q_mask(ap, tokens.device)
    x = L.embed_lookup(model.embed, tokens, ctx, mesh, ap.vocab_pad)
    seeds: List[Cache] = []
    for bp in model.blocks:
        x, st = block_forward(bp, x, ap, ctx, mesh, positions=positions,
                              q_mask=q_mask)
        if collect_state:
            seeds.append({n: L._fold(t) for n, t in st.items()})
    x = L.apply_norm(x, model.final_norm, ap.cfg)
    logits = _unranked(L.lm_logits(model.embed, x), mesh)
    states = {n: torch.stack([st[n] for st in seeds]) for n in seeds[0]} \
        if collect_state else None
    return logits, states


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def ef_sites_for(ctx: ParallelCtx, cfg: ModelConfig) -> int:
    """Error-feedback site count for ``init_cache(..., ef_sites=...)``: the
    dense decode threads EF through its two row-parallel reductions (attn
    wo, MLP down) whenever the ctx may quantize the wire (``ar_quant``
    forced or "auto"); other families (MoE and hybrid included, as in the
    reference) carry no EF leaf and take the one-shot rounding."""
    if ctx.ar_quant == "none" or cfg.family != "dense":
        return 0
    return 2


def fold_table(tbl: torch.Tensor, R: int, n_blocks: int) -> torch.Tensor:
    """A block table (B, max_blocks) folded over R ranks: (R*B,
    max_blocks), rank r's rows the table offset by ``r * n_blocks``, so
    rank r reads its own pool of ``n_blocks`` blocks (its block 0 its
    trash block) and one paged-decode launch serves every rank."""
    if R == 1:
        return tbl
    off = torch.arange(R, dtype=tbl.dtype, device=tbl.device) * n_blocks
    return (tbl[None] + off[:, None, None]).reshape(R * tbl.shape[0],
                                                   tbl.shape[1])


def init_cache(ap: ArchPlan, batch: int, s_max: int, *, block_size: int = 0,
               n_blocks: Optional[int] = None,
               device: torch.device | str, mesh=None,
               ef_sites: int = 0) -> Cache:
    """Decode cache, leading layer axis, per-rank (local) head counts as
    ``sharding.cache_spec`` cuts them (each rank holds ``ap.gqa.u`` kv
    slots), the R ranks folded into the batch, rank-major.

    ``block_size=0``: dense K/V (L, R*batch, s_max, U, hd).
    ``block_size>0``: paged K/V, a pool of ``n_blocks`` physical blocks a
    rank, (L, R*n_blocks, block_size, U, hd), plus ``block_tbl``
    (R*batch, s_max/block_size) int32, the batch's table folded over the
    ranks (:func:`fold_table`).  Block 0 of each rank's pool is its trash
    block.  ``n_blocks=None`` holds every slot at full length plus the
    trash block (batch * s_max/block_size + 1), and the table starts as
    the identity mapping from 1, which makes the paged cache hold the
    dense cache's contents block by block; a smaller pool starts all-trash
    and is managed by a :class:`~repro_torch.inference.kv_cache.
    BlockAllocator`, as in the reference.

    ``ef_sites > 0`` adds the error-feedback leaf ``ef`` (L, ef_sites, R,
    batch, d_model) f32, the reference's global layout with the ranks on
    its tp axis.

    The ssm family holds no K/V: its cache is the recurrent state,
    ``shift_tm``/``shift_cm`` (L, R*batch, d_model) in ``cfg.dtype`` and
    ``wkv`` (L, R*batch, H_local, hd, hd) f32.  It has nothing to page,
    so ``block_size > 0`` raises (the reference ignores it).

    The hybrid family holds the K/V above (dense or paged) and the mamba
    state: ``conv`` (L, R*batch, d_conv-1, Ci_local) in ``cfg.dtype`` and
    ``ssm`` (L, R*batch, Ci_local, s) f32, batch-indexed under paging
    too, as in the reference.
    """
    cfg = ap.cfg
    R = mesh.size if mesh is not None else 1
    if cfg.attn_free:
        if block_size > 0:
            raise ValueError(
                f"{cfg.name}: the ssm family has no K/V to page "
                f"(block_size={block_size}); its cache is the fixed-size "
                "recurrent state")
        st = RW.init_rwkv_state(cfg, R * batch, ap.rwkv_heads_local,
                                device=device, dtype=cfg.dtype)
        return {n: t.expand(cfg.n_layers, *t.shape).clone()
                for n, t in st.items()}
    u, hd, Ld = ap.gqa.u, cfg.head_dim, cfg.n_layers
    if block_size > 0:
        if s_max % block_size:
            raise ValueError(f"s_max={s_max} is not a multiple of "
                             f"block_size={block_size}")
        max_blocks = s_max // block_size
        full = batch * max_blocks + 1
        n_blocks = full if n_blocks is None else n_blocks
        shape = (Ld, R * n_blocks, block_size, u, hd)
        if n_blocks >= full:
            tbl = 1 + torch.arange(batch * max_blocks, dtype=torch.int32,
                                   device=device).reshape(batch, max_blocks)
        else:
            tbl = torch.zeros((batch, max_blocks), dtype=torch.int32,
                              device=device)
        cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "block_tbl": fold_table(tbl, R, n_blocks)}
    else:
        shape = (Ld, R * batch, s_max, u, hd)
        cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if cfg.family == "hybrid":
        st = SSM.init_ssm_state(cfg, R * batch, ap.d_inner_local,
                                device=device, dtype=cfg.dtype)
        cache.update({n: t.expand(Ld, *t.shape).clone()
                      for n, t in st.items()})
    if ef_sites > 0:
        cache["ef"] = torch.zeros((Ld, ef_sites, R, batch, cfg.d_model),
                                  dtype=torch.float32, device=device)
    return cache


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


def _cache_rows(cache: Cache) -> int:
    """R * batch: the folded batch of the cache's per-sequence leaves."""
    for n in ("block_tbl", "k") + RECURRENT_LEAVES:
        if n in cache:
            return cache[n].shape[0 if n == "block_tbl" else 1]
    raise ValueError("a cache with no per-sequence leaf")


def seed_cache(cache: Cache, states: Cache, slot: Optional[int] = None
               ) -> Cache:
    """Splice prefill-collected layer states into a decode cache at
    position 0, in place; returns ``cache``.

    ``slot=None``: batch-wide (the states' folded batch is the cache's).
    ``slot``: one request (states of batch 1 on each of the R ranks, folded
    (L, R, ...)) into row ``slot`` of every rank.  A paged cache
    (``block_tbl`` present) routes K/V through the slot's rows of the
    folded block table; the recurrent leaves (``RECURRENT_LEAVES``: the ssm
    family's, the hybrid family's ``conv``/``ssm``) are copied into the
    slot's rows.  An ``ef`` leaf is zeroed (the slot's, or all of it): a
    fresh request starts with no rounding residue of the slot's last
    occupant."""
    some = next(t for n, t in states.items() if n in cache)
    if slot is None:
        rows = slice(None)
    else:
        R = some.shape[1]
        rows = torch.arange(R, device=some.device) * (_cache_rows(cache)
                                                      // R) + slot
    if "ef" in cache:      # (L, sites, R, batch, D)
        cache["ef"][:, :, :, slice(None) if slot is None else slot].zero_()
    for n in RECURRENT_LEAVES:
        if n in cache:
            cache[n][:, rows] = states[n].to(cache[n].dtype)
    if "k" not in cache:
        return cache
    if "block_tbl" in cache:
        tbl = cache["block_tbl"][rows]
        _paged_splice(cache["k"], states["k"], tbl)
        _paged_splice(cache["v"], states["v"], tbl)
    else:
        S = states["k"].shape[2]
        cache["k"][:, rows, :S] = states["k"].to(cache["k"].dtype)
        cache["v"][:, rows, :S] = states["v"].to(cache["v"].dtype)
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def block_decode(bp: Block, x: torch.Tensor, cache_l: Cache, ap: ArchPlan,
                 ctx: ParallelCtx = LOCAL, mesh=None, *,
                 positions: torch.Tensor, kv_positions: torch.Tensor,
                 q_mask: Optional[torch.Tensor] = None,
                 block_tbl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block, one token.  x: (R, B, 1, D) replicated; cache_l: this
    layer's {"k", "v"[, "ef"]} (written in place).  Both row-parallel
    projections go through ``_residual_proj``: their reduction is the
    collective the paper targets.  A MoE block runs its dense path (every
    local expert on every token) and completes the TP-partial combine with
    ``tp_all_reduce``, the same collective.  With an ``ef`` leaf ((2, R,
    B, D), one site each) the projections consume and refresh their
    error-feedback residue, in the message layout (R, B, 1, D).  A hybrid
    block mixes its attention partial with the mamba step's (kernel 9
    stepping the cache's ``ssm`` in place, the new ``conv`` history copied
    back) before one ``tp_all_reduce``; it carries no ``ef``.  An ssm
    block reads and updates its recurrent leaves ({"shift_tm",
    "shift_cm"} (R*B, D), {"wkv"} (R*B, H, hd, hd)) in place: kernel 8
    steps the state, and the time-mix output and the stacked channel-mix
    partial each take one ``tp_all_reduce``.  Returns x."""
    cfg = ap.cfg
    if cfg.attn_free:
        shape = (*x.shape[:2], x.shape[-1])
        tm, st = RW.rwkv_time_mix_step(
            bp.tm, L.apply_norm(x, bp.ln1, cfg),
            {"shift_tm": cache_l["shift_tm"].view(shape),
             "wkv": cache_l["wkv"]}, cfg)
        cache_l["shift_tm"].copy_(st["shift_tm"].reshape(-1, shape[-1]))
        x = x + hier.tp_all_reduce(tm, ctx, mesh, scatter_dim=-1)
        stacked, st2 = RW.rwkv_channel_mix(
            bp.cm, L.apply_norm(x, bp.ln2, cfg), cfg,
            state={"shift_cm": cache_l["shift_cm"].view(shape)},
            return_state=True)
        cache_l["shift_cm"].copy_(st2["shift_cm"].reshape(-1, shape[-1]))
        return _cm_residual(x, stacked, ctx, mesh)
    ef = cache_l.get("ef")
    ef_in = (None, None) if ef is None \
        else (ef[0, :, :, None], ef[1, :, :, None])
    h = L.apply_norm(x, bp.ln1, cfg)
    heads = L.attention_decode(bp.attn, h, cache_l, cfg, positions=positions,
                               kv_positions=kv_positions, q_mask=q_mask,
                               block_tbl=block_tbl)
    if cfg.family == "hybrid":
        conv = cache_l["conv"]
        so, st = SSM.ssm_step(bp.ssm, h, {
            "conv": conv.view(*x.shape[:2], *conv.shape[1:]),
            "ssm": cache_l["ssm"]}, cfg)
        conv.copy_(st["conv"].reshape(conv.shape))
        x = _mixed_residual(x, bp.beta, ov.project(heads, bp.attn["wo"]), so,
                            ctx, mesh)
        ef_attn = ef_in[0]
    else:
        x, ef_attn = _residual_proj(x, heads, bp.attn["wo"], ctx, mesh,
                                    ef=ef_in[0])
    h2 = L.apply_norm(x, bp.ln2, cfg)
    if cfg.is_moe:
        x = x + hier.tp_all_reduce(M.moe_ffn_dense(bp.moe, h2, cfg, ctx,
                                                   mesh), ctx, mesh,
                                   scatter_dim=-1)
        ef_mlp = ef_in[1]
    else:
        x, ef_mlp = _residual_proj(x, L.mlp_hidden(bp.mlp, h2, cfg),
                                   L.mlp_down_w(bp.mlp, cfg), ctx, mesh,
                                   ef=ef_in[1])
    for site, new in enumerate((ef_attn, ef_mlp)):
        if new is not ef_in[site]:      # an unquantized call hands it back
            ef[site].copy_(new[:, :, 0])
    return x


def decode_step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
                positions: torch.Tensor, ap: ArchPlan,
                ctx: ParallelCtx = LOCAL, mesh=None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for the whole batch.

    tokens: (B,) int; positions: (B,) int32 write index.  Returns
    (logits, cache), the cache updated in place; logits vocab-sharded
    (R, B, V_local) on a mesh, (B, V_pad) without one.
    """
    R = check_layout(ap, ctx, mesh)
    block_tbl = cache.get("block_tbl")
    kv_positions = positions.repeat(R) if R > 1 else positions
    q_mask = _q_mask(ap, tokens.device)
    x = L.embed_lookup(model.embed, tokens[:, None], ctx, mesh, ap.vocab_pad)
    for i, bp in enumerate(model.blocks):
        cache_l = {n: cache[n][i] for n in ("k", "v", "ef")
                   + RECURRENT_LEAVES if n in cache}
        x = block_decode(bp, x, cache_l, ap, ctx, mesh, positions=positions,
                         kv_positions=kv_positions, q_mask=q_mask,
                         block_tbl=block_tbl)
    x = L.apply_norm(x, model.final_norm, ap.cfg)
    return _unranked(L.lm_logits(model.embed, x)[:, :, 0], mesh), cache


__all__ = ["ArchPlan", "make_plan", "check_layout", "Block", "DenseLM",
           "from_global", "init_params", "block_forward", "forward_lm",
           "ef_sites_for", "fold_table", "init_cache", "seed_cache",
           "block_decode",
           "decode_step", "RECURRENT_LEAVES"]
