"""Model assembly for every family of the reference (dense, MoE, ssm
(RWKV6), hybrid (Hymba), the encoder-decoder (whisper) and the VLM
(pixtral)): parameters, LM forward, caches and the decode step, at tp=1
and over the virtual mesh (the port of ``repro/models/transformer.py``).

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
prefill takes the one-shot rounding.  The decode variants are chosen by
the cache and the step: the int8 cache (``kv_quant``: int8 K/V beside
bf16 ``k_scale``/``v_scale``), the ring-buffer window cache
(``window_cache``, ``decode_step(kv_ring=True)``) and int8 block weights
(``weight_quant``: ``{q, s}`` leaves, ``decode_step(layer_map=...)``).

An encoder-decoder model (``cfg.enc_layers``) adds the encoder
(``enc_blocks``, ``enc_norm``: :func:`encoder_forward`, non-causal
self-attention and the gelu MLP over the precomputed frame embeddings)
and, in each decoder block after self-attention, ``ln_x`` and the
cross-attention ``xattn`` over the encoder's K/V, completed by a plain
TP reduction (never overlapped, as in the reference).  Its cache adds the
per-layer cross K/V ``enc_k``/``enc_v``, dense whatever the self-attention
layout, seeded once by the prefill and read by every decode step.  A VLM
(``cfg.n_patches``) is the dense decoder whose first positions take the
precomputed patch embeddings in place of the token embeddings.

Sequence-parallel prefill (``forward_lm(sp=...)``, ``ctx.seq_parallel``):
the residual stream stays cut on the sequence over the fast TP axis
between sublayers, (R, B, S / fast, D), rank (p, f) holding the f-th
piece.  The row-parallel projections and the embedding end in
``tp_reduce_scatter`` on the sequence, norms run on the piece, and
``tp_all_gather`` restores the full sequence only where attention, the
MLP's up-projection or the mixers need it; the final norm's output is
gathered back before the vocab head.  Decode and chunked prefill never
decompose.  A QKV-bias arch (``cfg.qkv_bias``) carries ``bq``/``bk``/
``bv`` in the attention group, in slot layout.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import autotune
from ..core import hierarchical as hier
from ..core import overlap as ov
from ..core.pcontext import LOCAL, ParallelCtx
from ..core.tree import key_names, tree_map, tree_map_with_path
from ..parallel.sharding import shard_params, tp_dim
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
# The attention cache's leaves a row operation moves together: K/V and,
# in the int8 cache, their per-(position, head) scales.
KV_LEAVES = ("k", "v", "k_scale", "v_scale")
# The encoder-decoder's per-layer cross-attention K/V, batch-indexed (never
# paged) and written only when a prompt is seeded.
ENC_LEAVES = ("enc_k", "enc_v")


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
    the reference does not check (ROADMAP §3).  The encoder-decoder and
    VLM plans are the dense GQA plan (the encoder and the cross-attention
    take the decoder's slot layout)."""
    if cfg.family == "encdec" and (cfg.enc_layers <= 0 or cfg.enc_seq <= 0):
        raise ValueError(f"{cfg.name}: an encoder-decoder needs enc_layers "
                         f"and enc_seq > 0, got {cfg.enc_layers}, "
                         f"{cfg.enc_seq}")
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
    """Raise unless (ap, ctx, mesh) describe one layout; returns R.  The
    ctx's ``dp``, ``fsdp`` and ``sp`` axes are the reference's training
    layout (``sp`` is set only by its training constructors, and never
    read: sequence-parallel prefill is ``seq_parallel``)."""
    if ctx.dp or ctx.fsdp or ctx.sp:
        raise NotImplementedError(
            f"ctx dp={ctx.dp} fsdp={ctx.fsdp} sp={ctx.sp}: the virtual mesh "
            "holds the TP axes only; batch-, weight- and sequence-sharded "
            "training layouts arrive with ROADMAP item 11")
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
    """Frozen parameters; a quantized leaf (``parallel/quant.py``) stays
    the plain {"q", "s"} dict of tensors."""
    return nn.ParameterDict({k: t if isinstance(t, Mapping)
                             else nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class Block(nn.Module):
    """One layer's parameter groups, each (R, *local): ``ln1``, ``attn``
    (wq, wk, wv, wo; bq, bk, bv under ``qkv_bias``), ``ln2``, and either
    ``mlp`` (wg, wu, wd; the gelu MLP's w1, b1, w2) or ``moe`` (router
    f32; wg, wu, wd cut on the expert axis); a hybrid block adds ``ssm``
    (the mamba mixer) and ``beta``, a bare (R, 2) f32 tensor; an
    encoder-decoder's decoder block adds ``ln_x`` and ``xattn`` (the
    cross-attention, laid out as ``attn``); or, for the ssm family,
    ``ln1``, ``tm`` (the RWKV6 time-mix), ``ln2``, ``cm`` (the
    channel-mix).  A layernorm group holds ``w`` and ``b``."""

    def __init__(self, tensors: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        for name, group in tensors.items():
            setattr(self, name, nn.Parameter(group, requires_grad=False)
                    if isinstance(group, torch.Tensor) else _frozen(group))


class DenseLM(nn.Module):
    """A model of any ported family: ``embed`` (tok, head), ``blocks``,
    ``final_norm``, and for the encoder-decoder ``enc_blocks`` (ln1, attn,
    ln2, mlp) and ``enc_norm`` (empty otherwise), every leaf stacked per
    rank.  Built by :func:`init_params` or, from the JAX package's
    parameters, by :func:`repro_torch.models.bridge.params_from_numpy`.
    """

    def __init__(self, embed: Mapping[str, torch.Tensor],
                 blocks: List[Mapping[str, Mapping[str, torch.Tensor]]],
                 final_norm: Mapping[str, torch.Tensor],
                 enc_blocks: List[Mapping[str, Mapping[str, torch.Tensor]]]
                 = (), enc_norm: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)
        self.final_norm = _frozen(final_norm)
        self.enc_blocks = nn.ModuleList(Block(b) for b in enc_blocks)
        self.enc_norm = _frozen(enc_norm or {})

    @property
    def n_ranks(self) -> int:
        return self.embed["tok"].shape[0]


def from_global(tree: Mapping, mesh=None) -> DenseLM:
    """A DenseLM from a global-layout tree {"embed", "blocks" (a list of
    per-layer groups), "final_norm"[, "enc_blocks", "enc_norm"]}, cut over
    the mesh's ranks."""
    return _model(shard_params(tree, mesh))


def params_tree(model: DenseLM) -> dict:
    """The model's leaves (the parameters themselves, (R, *local)) as a
    tree of plain dicts and lists in :func:`from_global`'s layout:
    {"embed", "blocks" (a list of per-layer groups; a bare leaf such as
    the hybrid ``beta`` a tensor), "final_norm"[, "enc_blocks",
    "enc_norm"]}."""
    def block(bp: Block) -> dict:
        out = {n: dict(g.items()) for n, g in bp.named_children()}
        out.update(bp.named_parameters(recurse=False))
        return out

    tree = {"embed": dict(model.embed.items()),
            "blocks": [block(bp) for bp in model.blocks],
            "final_norm": dict(model.final_norm.items())}
    if len(model.enc_blocks):
        tree["enc_blocks"] = [block(bp) for bp in model.enc_blocks]
        tree["enc_norm"] = dict(model.enc_norm.items())
    return tree


def _model(tree: Mapping) -> DenseLM:
    return DenseLM(tree["embed"], tree["blocks"], tree["final_norm"],
                   tree.get("enc_blocks", ()), tree.get("enc_norm"))


def to_global(model: DenseLM, mesh=None) -> dict:
    """The unranked tree that :func:`from_global` cuts (its inverse): on
    a TP mesh each leaf with a TP dimension has its R pieces concatenated
    on it (every leaf of a plan's model divides: ``make_plan`` pads) and
    every other leaf is rank 0's copy; without a mesh (tp=1, and the
    train step's data-parallel replicas) every leaf is rank 0's copy.
    Tensors detached from autograd, the model's dtypes."""
    def leaf(path, t):
        t = t.detach()
        d = tp_dim(key_names(path), t.dim() - 1) if mesh is not None \
            and mesh.size > 1 else None
        if d is None:
            return t[0]
        return torch.cat(list(t.unbind(0)), dim=d)

    return tree_map_with_path(leaf, params_tree(model))


def data_parallel(model: DenseLM, replicas: int) -> DenseLM:
    """A model of ``replicas`` ranks, each a copy of rank 0 of ``model``
    (a tp=1 model): the data-parallel train step's layout over the pods
    of a ``VirtualMesh(replicas, 1)``, every leaf (replicas, *global)."""
    return _model(tree_map(lambda t: t.detach()[:1].expand(
        replicas, *t.shape[1:]).contiguous(), params_tree(model)))


def trainable(model: DenseLM, on: bool = True) -> DenseLM:
    """Let autograd track every leaf of ``model`` (``on``), or freeze them
    again (serving's default: ``init_params`` and the bridge build frozen
    leaves); returns the model."""
    for p in model.parameters():
        p.requires_grad_(on)
    return model


def init_params(ap: ArchPlan, *, seed: int, device: torch.device | str,
                mesh=None) -> DenseLM:
    """The port's own seeded init: the shapes and scales of the JAX
    ``init_params`` at ``ap.tp`` (weights Normal(0, 1/fan_in) in the
    plan's slot layout, norm weights 1 and a layernorm's ``b`` 0, QKV
    biases and the gelu MLP's ``b1`` zero as the reference draws them, a
    MoE router in f32; the RWKV6 groups of ``rwkv.init_rwkv_*``; the mamba
    group of ``ssm.init_ssm`` and ``beta`` ones in f32; an
    encoder-decoder's ``ln_x``/``xattn`` in every decoder block, then its
    encoder blocks and ``enc_norm``), drawn from a ``torch.Generator`` on
    ``device``
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

    def norm():
        g = ones(d)
        if cfg.norm == "layernorm":
            g["b"] = torch.zeros(d, dtype=dt, device=device)
        return g

    def attention():
        wq = dense_init(gen, (cfg.n_heads, d, hd), d, dt)
        wk = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wv = dense_init(gen, (cfg.n_kv_heads, d, hd), d, dt)
        wo = dense_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd, dt)
        attn = {"wq": place_heads(wq, plan.q_map).transpose(0, 1).contiguous(),
                "wk": place_heads(wk, plan.kv_map).transpose(0, 1).contiguous(),
                "wv": place_heads(wv, plan.kv_map).transpose(0, 1).contiguous(),
                "wo": place_heads(wo, plan.q_map)}
        if cfg.qkv_bias:
            for name, n, m in (("bq", cfg.n_heads, plan.q_map),
                               ("bk", cfg.n_kv_heads, plan.kv_map),
                               ("bv", cfg.n_kv_heads, plan.kv_map)):
                attn[name] = place_heads(torch.zeros(
                    (n, hd), dtype=dt, device=device), m)
        return attn

    def mlp():
        if cfg.act == "swiglu":
            return {"wg": dense_init(gen, (d, f), d, dt),
                    "wu": dense_init(gen, (d, f), d, dt),
                    "wd": dense_init(gen, (f, d), f, dt)}
        return {"w1": dense_init(gen, (d, f), d, dt),
                "b1": torch.zeros(f, dtype=dt, device=device),
                "w2": dense_init(gen, (f, d), f, dt)}

    def block():
        if cfg.attn_free:
            return shard_params({"ln1": ones(d),
                                 "tm": RW.init_rwkv_time_mix(gen, cfg),
                                 "ln2": ones(d),
                                 "cm": RW.init_rwkv_channel_mix(gen, cfg)},
                                mesh)
        blk = {"ln1": norm(), "attn": attention(), "ln2": norm()}
        if cfg.family == "hybrid":
            blk["ssm"] = SSM.init_ssm(gen, cfg)
            blk["beta"] = torch.ones(2, dtype=torch.float32, device=device)
        if cfg.is_moe:
            blk["moe"] = M.init_moe(gen, cfg)
        else:
            blk["mlp"] = mlp()
        if cfg.enc_layers:
            blk["ln_x"], blk["xattn"] = norm(), attention()
        return shard_params(blk, mesh)

    def enc_block():
        return shard_params({"ln1": norm(), "attn": attention(),
                             "ln2": norm(), "mlp": mlp()}, mesh)

    pad = ap.vocab_pad - cfg.vocab_size
    embed = {"tok": torch.nn.functional.pad(
        dense_init(gen, (cfg.vocab_size, d), d, dt), (0, 0, 0, pad))}
    if not cfg.tie_embeddings:
        embed["head"] = torch.nn.functional.pad(
            dense_init(gen, (d, cfg.vocab_size), d, dt), (0, pad))
    embed = shard_params(embed, mesh)
    blocks = [block() for _ in range(cfg.n_layers)]
    enc = [enc_block() for _ in range(cfg.enc_layers)]
    return DenseLM(embed, blocks, shard_params(norm(), mesh), enc,
                   shard_params(norm(), mesh) if cfg.enc_layers else None)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _seq_parallel_active(ctx: ParallelCtx, mesh, cfg: ModelConfig,
                         n_tokens: int, seq_len: int,
                         explicit: Optional[bool]) -> bool:
    """The sequence-parallel layout of one prefill call.  It engages only
    with a fast TP axis of size > 1 that divides the sequence (else the
    fused path, the same numbers).  ``explicit`` (a caller's ``sp=``)
    overrides the ``ctx.seq_parallel`` knob; from the knob it never
    engages for the recurrent families (ssm, hybrid), and ``"auto"`` asks
    the active tuner (:func:`~repro_torch.core.autotune.resolve_sp`) with
    this call's residual message, ``n_tokens * d_model * itemsize``: the
    step builders call under their own tuner (``autotune.using``)."""
    if not ctx.tp_fast:
        return False
    fast = hier.axes_size(ctx.tp_fast, mesh)
    if fast <= 1 or seq_len % fast:
        return False
    if explicit is not None:
        return bool(explicit)
    mode = ctx.seq_parallel
    if mode == "off" or cfg.family in ("ssm", "hybrid"):
        return False
    if mode == "on":
        return True
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    slow = hier.axes_size(ctx.tp_slow, mesh) if ctx.tp_slow else 1
    return autotune.resolve_sp(n_tokens * cfg.d_model * itemsize, fast,
                               slow, hier.dtype_name(cfg.dtype))


def _residual(x: torch.Tensor, partial: torch.Tensor, ctx: ParallelCtx,
              mesh, sp: bool, dim: int = 1) -> torch.Tensor:
    """x plus a TP partial completed: reduce-scattered on the sequence
    (``dim`` of one rank's tensor) under SP, else all-reduced."""
    if sp:
        return x + hier.tp_reduce_scatter(partial, ctx, mesh, dim=dim)
    return x + hier.tp_all_reduce(partial, ctx, mesh, scatter_dim=-1)


def _gathered(x: torch.Tensor, ctx: ParallelCtx, mesh,
              sp: bool) -> torch.Tensor:
    """The full sequence of a sequence-parallel activation (R, B, S/fast,
    D): ``tp_all_gather`` under SP, x itself otherwise."""
    return hier.tp_all_gather(x, ctx, mesh, dim=1) if sp else x


def _use_overlap(ctx: ParallelCtx) -> bool:
    """Route the row-parallel output projections through the overlapped
    collective matmul."""
    return ctx.overlap_matmul and ctx.has_tp


def _residual_proj(x: torch.Tensor, lhs: torch.Tensor, w: torch.Tensor,
                   ctx: ParallelCtx, mesh, ef: Optional[torch.Tensor] = None,
                   sp: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x plus the TP-reduced projection of ``lhs`` (the pre-projection
    activation, (R, B, S, *c)) by the row-sharded ``w`` ((R, *c, D)), the
    new error-feedback residue): overlapped when the ctx asks for it, else
    the projection then ``tp_all_reduce``.  ``ef`` (R, B, S, D) is this
    site's residue (None: no EF, and None comes back).  ``sp``: the
    reduction is ``tp_reduce_scatter`` on the sequence (under overlap
    ``collective_matmul_reduce_scatter``); prefill only, so no EF."""
    if sp:
        if _use_overlap(ctx):
            return x + ov.collective_matmul_reduce_scatter(
                lhs, w, ctx, mesh, dim=1), None
        return _residual(x, ov.project(lhs, w), ctx, mesh, True), None
    if _use_overlap(ctx):
        y = ov.collective_matmul(lhs, w, ctx, mesh, ef=ef)
    else:
        y = hier.tp_all_reduce(ov.project(lhs, w), ctx, mesh, scatter_dim=-1,
                               ef=ef)
    y, ef = y if ef is not None else (y, None)
    return x + y, ef


def _moe_tokens(h: torch.Tensor, ctx: ParallelCtx, mesh,
                sp: bool = False) -> torch.Tensor:
    """MoE consumes per-rank-unique tokens (no exchange): rank r takes the
    r-th contiguous chunk of the sequence of h (R, B, S, D).  Under SP h
    is already cut over the fast axis, and rank (p, f) takes chunk p of
    its piece f: the port's EP group spans the pods too (``ep`` = the TP
    axes), so the pods must not dispatch the same tokens.  On a pipeline
    mesh each stage's TP group dispatches its own buffer (rank r takes
    chunk r mod tp)."""
    if not ctx.has_tp:
        return h
    R, B, S, D = h.shape
    pods, fast = hier._sizes(ctx, mesh)
    tp = pods * fast
    n = pods if sp else tp
    if S % n:
        raise ValueError(f"sequence {S} is not divisible by tp={tp}: the "
                         "MoE dispatch gives every rank S/tp of its tokens")
    r = torch.arange(R, device=h.device)
    return h.reshape(R, B, n, S // n, D)[r, :, r % tp // (tp // n)]


def _moe_restore(out: torch.Tensor, ctx: ParallelCtx, mesh,
                 sp: bool = False) -> torch.Tensor:
    """The ranks' sequence chunks gathered back: to the full sequence, or
    under SP to each rank's fast piece (a gather over the pods)."""
    if sp:
        return hier.pod_all_gather_tiled(out, ctx, mesh, dim=1)
    return hier.all_gather_tiled(out, ctx, mesh, dim=1)


def _cm_residual(x: torch.Tensor, stacked: torch.Tensor, ctx: ParallelCtx,
                 mesh, sp: bool = False) -> torch.Tensor:
    """x plus the gated channel-mix: the stacked (value, receptance logit)
    partial (R, 2, B, S, D) completed by one ``tp_all_reduce`` (under SP
    ``tp_reduce_scatter`` on the sequence), then ``sigmoid(r) * v``."""
    red = hier.tp_reduce_scatter(stacked, ctx, mesh, dim=2) if sp \
        else hier.tp_all_reduce(stacked, ctx, mesh, scatter_dim=-1)
    return x + torch.sigmoid(red[:, 1].float()).to(x.dtype) * red[:, 0]


def _mixed_residual(x: torch.Tensor, beta: torch.Tensor, attn: torch.Tensor,
                    ssm: torch.Tensor, ctx: ParallelCtx, mesh,
                    sp: bool = False) -> torch.Tensor:
    """x plus the hybrid block's mix: ``beta`` (R, 2) f32 cast to the
    activation dtype, as the reference casts it, ``beta0 * attn + beta1 *
    ssm`` over the two TP-partial outputs (R, B, S, D), completed by one
    ``tp_all_reduce`` (under SP ``tp_reduce_scatter``)."""
    b = beta.to(attn.dtype)
    mix = L.per_rank(b[:, :1], attn) * attn + L.per_rank(b[:, 1:], ssm) * ssm
    return _residual(x, mix, ctx, mesh, sp)


def _sp_piece(x: torch.Tensor, ctx: ParallelCtx, mesh) -> torch.Tensor:
    """A replicated activation (R, B, S, D) cut to the sequence-parallel
    layout, (R, B, S / fast, D), rank (p, f) holding piece f: where
    ``tp_reduce_scatter`` leaves its result (the reference slices by the
    rank over every TP axis, which is that layout at one pod only; ROADMAP
    §3)."""
    R, B, S = x.shape[:3]
    fast = hier._sizes(ctx, mesh)[1]
    r = torch.arange(R, device=x.device)
    return x.reshape(R, B, fast, S // fast, *x.shape[3:])[r, :, r % fast]


def encoder_forward(model: DenseLM, frames: torch.Tensor, ap: ArchPlan,
                    ctx: ParallelCtx = LOCAL, mesh=None, *,
                    sp: bool = False) -> torch.Tensor:
    """The encoder (the port of ``encoder_forward``): frames (B, T, D), the
    precomputed frame embeddings (the front end is a stub), cast to the
    model's dtype and replicated on every rank -> the encoder's output
    (R, B, T, D).  Each block: ``ln1``, non-causal self-attention through
    kernel 3 with RoPE at positions 0..T-1, ``wo`` and a TP reduction;
    ``ln2``, the MLP and a TP reduction (never overlapped, as in the
    reference); then ``enc_norm``.  ``sp`` (the prefill's sequence-parallel
    layout) cuts the residual stream on T over the fast axis when the fast
    axis divides T: the reductions end in ``tp_reduce_scatter``, attention
    and the MLP's up-projection read the gathered sequence, and the output
    is gathered back."""
    cfg = ap.cfg
    R, T = model.n_ranks, frames.shape[1]
    sp = sp and T % hier._sizes(ctx, mesh)[1] == 0
    x = frames.to(cfg.dtype)[None].expand(R, *frames.shape)
    if sp:
        x = _sp_piece(x, ctx, mesh)
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)
    q_mask = _q_mask(ap, frames.device)
    for bp in model.enc_blocks:
        h = _gathered(L.apply_norm(x, bp.ln1, cfg), ctx, mesh, sp)
        heads, _ = L.attention_prefill(bp.attn, h, cfg, positions=positions,
                                       q_mask=q_mask, causal=False)
        x = _residual(x, ov.project(heads, bp.attn["wo"]), ctx, mesh, sp)
        h2 = _gathered(L.apply_norm(x, bp.ln2, cfg), ctx, mesh, sp)
        x = _residual(x, ov.project(L.mlp_hidden(bp.mlp, h2, cfg),
                                    L.mlp_down_w(bp.mlp, cfg)), ctx, mesh, sp)
    return _gathered(L.apply_norm(x, model.enc_norm, cfg), ctx, mesh, sp)


def block_forward(bp: Block, x: torch.Tensor, ap: ArchPlan,
                  ctx: ParallelCtx = LOCAL, mesh=None, *,
                  positions: torch.Tensor,
                  q_mask: Optional[torch.Tensor] = None,
                  sp: bool = False,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    """One causal block over the full sequence, x (R, B, S, D) replicated,
    or under ``sp`` the residual's sequence piece (R, B, S / fast, D).
    Returns (x, the layer's prefill cache seed, always of the full
    sequence): the rotated K/V {"k", "v"} (R, B, S, U, hd), for a hybrid
    block with the mamba state {"conv"} (R, B, K-1, Ci) and {"ssm"}
    (R, B, Ci, s) beside them, or for an ssm block the recurrent state
    {"shift_tm", "shift_cm"} (R, B, D) and {"wkv"} (R, B, H, hd, hd).  The
    row-parallel projections go through ``_residual_proj``, except a
    hybrid block's attention ``wo``, whose partial is mixed with the mamba
    mixer's before its one reduction (``_mixed_residual``); a MoE block
    runs the dispatch path on each rank's chunk of the sequence and
    gathers the outputs back (its load-balancing loss, which only training
    reads, is dropped).  Under ``sp`` the norms run on the piece, every
    reduction is a ``tp_reduce_scatter`` on the sequence, and
    ``tp_all_gather`` gives the full sequence to attention, the mixers and
    the MLP's up-projection; a MoE block dispatches chunk p of its piece
    on rank (p, f) and gathers the chunks back over the pods.  With
    ``enc_out`` (the encoder's output, (R, B, T, D)) an encoder-decoder
    block runs, after self-attention, ``ln_x`` and the cross-attention
    over this layer's K/V of ``enc_out`` (kernel 3 non-causal), projected
    by ``xattn.wo`` and completed by ``_residual``; those K/V join the
    seed as {"enc_k", "enc_v"} (R, B, T, U, hd)."""
    cfg = ap.cfg
    h = _gathered(L.apply_norm(x, bp.ln1, cfg), ctx, mesh, sp)
    if cfg.attn_free:
        tm, st = RW.rwkv_time_mix(bp.tm, h, cfg, return_state=True)
        x = _residual(x, tm, ctx, mesh, sp)
        h2 = _gathered(L.apply_norm(x, bp.ln2, cfg), ctx, mesh, sp)
        stacked, st2 = RW.rwkv_channel_mix(bp.cm, h2, cfg, return_state=True)
        st["wkv"] = st["wkv"].reshape(*x.shape[:2], *st["wkv"].shape[1:])
        return _cm_residual(x, stacked, ctx, mesh, sp), {**st, **st2}
    heads, kv = L.attention_prefill(bp.attn, h, cfg, positions=positions,
                                    q_mask=q_mask)
    st = {"k": kv[0], "v": kv[1]}
    if cfg.family == "hybrid":
        so, sst = SSM.ssm_mixer(bp.ssm, h, cfg, return_state=True)
        st["conv"] = sst["conv"]
        st["ssm"] = sst["ssm"].reshape(*x.shape[:2], *sst["ssm"].shape[1:])
        x = _mixed_residual(x, bp.beta, ov.project(heads, bp.attn["wo"]), so,
                            ctx, mesh, sp)
    else:
        x, _ = _residual_proj(x, heads, bp.attn["wo"], ctx, mesh, sp=sp)
    if enc_out is not None:
        st["enc_k"], st["enc_v"] = L.cross_kv(bp.xattn, enc_out)
        heads = L.cross_attention(
            bp.xattn, _gathered(L.apply_norm(x, bp.ln_x, cfg), ctx, mesh, sp),
            L._fold(st["enc_k"]), L._fold(st["enc_v"]), q_mask=q_mask)
        x = _residual(x, ov.project(heads, bp.xattn["wo"]), ctx, mesh, sp)
    h2 = L.apply_norm(x, bp.ln2, cfg)
    if cfg.is_moe:
        out, _ = M.moe_ffn(bp.moe, _moe_tokens(h2, ctx, mesh, sp), cfg, ctx,
                           mesh, decode=False)
        return x + _moe_restore(out, ctx, mesh, sp), st
    x, _ = _residual_proj(x, L.mlp_hidden(bp.mlp, _gathered(h2, ctx, mesh,
                                                            sp), cfg),
                          L.mlp_down_w(bp.mlp, cfg), ctx, mesh, sp=sp)
    return x, st


def _unranked(t: torch.Tensor, mesh) -> torch.Tensor:
    """Public outputs keep the reference's layouts: without a mesh (tp=1)
    the rank axis of size 1 is dropped."""
    return t if mesh is not None else t[0]


def forward_lm(model: DenseLM, tokens: torch.Tensor, ap: ArchPlan,
               ctx: ParallelCtx = LOCAL, mesh=None, *,
               sp: Optional[bool] = None, collect_state: bool = False,
               frame_embeds: Optional[torch.Tensor] = None,
               patch_embeds: Optional[torch.Tensor] = None,
               remat: bool = False
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """tokens (B, S) -> (logits, states).

    ``remat`` (training) checkpoints each block (``torch.utils.checkpoint``
    without reentrancy): its activations are recomputed in the backward
    pass, as the reference's ``jax.checkpoint`` of the layer body with
    nothing saveable; it takes no ``collect_state``.  Without TP axes the
    tokens may be per rank, (R, B, S) for a model of R ranks (the data-
    parallel train step's replicas, each on its own batch); the logits
    then keep the rank axis, (R, B, S, V_pad).

    ``frame_embeds`` (B, T, D): an encoder-decoder's frames, which the
    encoder (:func:`encoder_forward`) reads first; every decoder block
    cross-attends over its output.  ``patch_embeds`` (B, P, D): a VLM's
    patches, which take positions [0, P) in place of the token embeddings
    (the embedding runs unsharded, then the overwritten sequence is cut
    to the sequence-parallel piece when SP is on); a prompt shorter than
    P raises ``ValueError``.  Both are cast to the model's dtype and are
    the same on every rank.

    ``sp=None`` resolves the sequence-parallel layout from
    ``ctx.seq_parallel`` for this call (:func:`_seq_parallel_active`); a
    bool forces it, subject to the fast axis dividing the sequence.  A
    sequence-parallel residual is gathered back to the full sequence
    after the final norm, before the vocab head; the states are the full
    sequence's either way.

    ``logits`` are vocab-sharded, (R, B, S, V_local), on a mesh and
    (B, S, V_pad) without one.  ``states`` (when ``collect_state``) hold
    the per-layer cache seeds stacked on a leading layer axis, the ranks
    folded into the batch as in the cache: {"k", "v"} (L, R*B, S, U, hd),
    for the hybrid family with {"conv"} (L, R*B, K-1, Ci) and {"ssm"}
    (L, R*B, Ci, s) beside them, for the encoder-decoder with {"enc_k",
    "enc_v"} (L, R*B, T, U, hd), each layer's cross K/V computed once, or
    for the ssm family {"shift_tm", "shift_cm"} (L, R*B, D) and {"wkv"}
    (L, R*B, H, hd, hd); else None.  (The JAX function also returns the
    MoE load-balancing loss, which only training reads, and the encoder's
    output, whose only use, the cross K/V, is in the states here.)
    """
    check_layout(ap, ctx, mesh)
    cfg = ap.cfg
    B, S = tokens.shape[-2:]
    if remat and collect_state:
        raise ValueError("remat recomputes the blocks in the backward pass; "
                         "collect_state has none")
    if cfg.enc_layers and frame_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                         "frame_embeds (B, enc_seq, d_model)")
    sp = _seq_parallel_active(ctx, mesh, cfg, B * S, S, sp)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    q_mask = _q_mask(ap, tokens.device)
    if patch_embeds is None:
        x = L.embed_lookup(model.embed, tokens, ctx, mesh, ap.vocab_pad,
                           sp=sp)
    else:
        P = patch_embeds.shape[1]
        if P > S:
            raise ValueError(f"a prompt of {S} tokens is shorter than its "
                             f"{P} patch embeddings")
        x = L.embed_lookup(model.embed, tokens, ctx, mesh, ap.vocab_pad)
        x = torch.cat([patch_embeds.to(x.dtype)[None].expand(
            x.shape[0], *patch_embeds.shape), x[:, :, P:]], dim=2)
        if sp:
            x = _sp_piece(x, ctx, mesh)
    enc_out = None if not cfg.enc_layers else encoder_forward(
        model, frame_embeds, ap, ctx, mesh, sp=sp)
    seeds: List[Cache] = []
    for bp in model.blocks:
        if remat:
            x = checkpoint(lambda bp_, x_: block_forward(
                bp_, x_, ap, ctx, mesh, positions=positions, q_mask=q_mask,
                sp=sp, enc_out=enc_out)[0], bp, x, use_reentrant=False)
            continue
        x, st = block_forward(bp, x, ap, ctx, mesh, positions=positions,
                              q_mask=q_mask, sp=sp, enc_out=enc_out)
        if collect_state:
            seeds.append({n: L._fold(t) for n, t in st.items()})
    x = _gathered(L.apply_norm(x, model.final_norm, ap.cfg), ctx, mesh, sp)
    logits = L.lm_logits(model.embed, x)
    if tokens.dim() == 2:
        logits = _unranked(logits, mesh)
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
               ef_sites: int = 0, kv_quant: bool = False,
               window_cache: bool = False) -> Cache:
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

    ``kv_quant``: int8 K/V with bf16 ``k_scale``/``v_scale`` (L, R*batch,
    s_max, U), one scale a (position, head).  ``window_cache``: the ring
    buffer of a sliding-window arch, ``s_max = min(s_max,
    sliding_window)``.  Both take the dense layout only (a paged cache
    with either raises, as the reference asserts); the ssm family ignores
    ``kv_quant`` (it has no K/V).

    The ssm family holds no K/V: its cache is the recurrent state,
    ``shift_tm``/``shift_cm`` (L, R*batch, d_model) in ``cfg.dtype`` and
    ``wkv`` (L, R*batch, H_local, hd, hd) f32.  It has nothing to page,
    so ``block_size > 0`` raises (the reference ignores it).

    The hybrid family holds the K/V above (dense or paged) and the mamba
    state: ``conv`` (L, R*batch, d_conv-1, Ci_local) in ``cfg.dtype`` and
    ``ssm`` (L, R*batch, Ci_local, s) f32, batch-indexed under paging
    too, as in the reference.

    The encoder-decoder adds the cross-attention K/V ``enc_k``/``enc_v``
    (L, R*batch, enc_seq, U, hd) in ``cfg.dtype``, dense under paging and
    under ``kv_quant`` too, as in the reference.
    """
    cfg = ap.cfg
    R = mesh.size if mesh is not None else 1
    if window_cache:
        if cfg.sliding_window <= 0:
            raise ValueError(f"{cfg.name}: the window cache needs a "
                             "sliding-window arch")
        s_max = min(s_max, cfg.sliding_window)
    if block_size > 0 and (kv_quant or window_cache):
        raise ValueError("paged cache is incompatible with "
                         "kv_quant/window_cache")
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
        kv_dt = torch.int8 if kv_quant else cfg.dtype
        cache = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
                 "v": torch.zeros(shape, dtype=kv_dt, device=device)}
        if kv_quant:
            for n in ("k_scale", "v_scale"):
                cache[n] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)
    if cfg.family == "hybrid":
        st = SSM.init_ssm_state(cfg, R * batch, ap.d_inner_local,
                                device=device, dtype=cfg.dtype)
        cache.update({n: t.expand(Ld, *t.shape).clone()
                      for n, t in st.items()})
    for n in ENC_LEAVES if cfg.enc_layers else ():
        cache[n] = torch.zeros((Ld, R * batch, cfg.enc_seq, u, hd),
                               dtype=cfg.dtype, device=device)
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
    slot's rows, and so are an encoder-decoder's cross K/V
    (``ENC_LEAVES``).  An ``ef`` leaf is zeroed (the slot's, or all of it): a
    fresh request starts with no rounding residue of the slot's last
    occupant.  An int8 cache (``k_scale`` present) takes the prompt's K/V
    quantized per (position, head) as the decode write quantizes them
    (``layers.quantize_kv``, the reference's splice).  A prompt longer
    than the cache (a ring of W slots) raises ``ValueError``, as the
    reference's ``dynamic_update_slice`` cannot take it either."""
    if "k" in states and "k" in cache and "block_tbl" not in cache \
            and states["k"].shape[2] > cache["k"].shape[2]:
        raise ValueError(f"a prompt of {states['k'].shape[2]} tokens does "
                         f"not fit a cache of {cache['k'].shape[2]} "
                         "positions")
    some = next(t for n, t in states.items() if n in cache)
    if slot is None:
        rows = slice(None)
    else:
        R = some.shape[1]
        rows = torch.arange(R, device=some.device) * (_cache_rows(cache)
                                                      // R) + slot
    if "ef" in cache:      # (L, sites, R, batch, D)
        cache["ef"][:, :, :, slice(None) if slot is None else slot].zero_()
    for n in RECURRENT_LEAVES + ENC_LEAVES:
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
        for n in ("k", "v"):
            if "k_scale" in cache:
                cache[n][:, rows, :S], cache[n + "_scale"][:, rows, :S] = \
                    L.quantize_kv(states[n])
            else:
                cache[n][:, rows, :S] = states[n].to(cache[n].dtype)
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def block_decode(bp: Block, x: torch.Tensor, cache_l: Cache, ap: ArchPlan,
                 ctx: ParallelCtx = LOCAL, mesh=None, *,
                 positions: torch.Tensor, kv_positions: torch.Tensor,
                 q_mask: Optional[torch.Tensor] = None,
                 block_tbl: Optional[torch.Tensor] = None,
                 kv_ring: bool = False) -> torch.Tensor:
    """One block, one token.  x: (R, B, 1, D) replicated; cache_l: this
    layer's {"k", "v"[, "k_scale", "v_scale"][, "ef"]} (written in place;
    ``kv_ring``: a ring-buffer window cache).  Both row-parallel
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
    partial each take one ``tp_all_reduce``.  An encoder-decoder block
    (``enc_k``/``enc_v`` (R*B, T, U, hd) in ``cache_l``) cross-attends
    after self-attention: ``ln_x``, one query over the T encoder keys
    through kernel 1, ``xattn.wo`` and a plain ``tp_all_reduce`` (no
    overlap and no error feedback, as in the reference).  Returns x."""
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
                               block_tbl=block_tbl, ring=kv_ring)
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
    if "enc_k" in cache_l:
        heads = L.cross_attention(bp.xattn, L.apply_norm(x, bp.ln_x, cfg),
                                  cache_l["enc_k"], cache_l["enc_v"],
                                  q_mask=q_mask, decode=True)
        x = x + hier.tp_all_reduce(ov.project(heads, bp.xattn["wo"]), ctx,
                                   mesh, scatter_dim=-1)
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
                ctx: ParallelCtx = LOCAL, mesh=None, *, layer_map=None,
                kv_ring: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One decode step for the whole batch.

    tokens: (B,) int; positions: (B,) int32 write index.  Returns
    (logits, cache), the cache updated in place; logits vocab-sharded
    (R, B, V_local) on a mesh, (B, V_pad) without one.  ``layer_map``
    (a :class:`~repro_torch.parallel.quant.LayerMap` under
    ``weight_quant``) maps each block before it runs, as the reference's
    hook; ``kv_ring``: the cache is the ring-buffer window cache.
    """
    R = check_layout(ap, ctx, mesh)
    block_tbl = cache.get("block_tbl")
    kv_positions = positions.repeat(R) if R > 1 else positions
    q_mask = _q_mask(ap, tokens.device)
    x = L.embed_lookup(model.embed, tokens[:, None], ctx, mesh, ap.vocab_pad)
    for i, bp in enumerate(model.blocks):
        cache_l = {n: cache[n][i] for n in KV_LEAVES + ("ef",)
                   + RECURRENT_LEAVES + ENC_LEAVES if n in cache}
        x = block_decode(bp if layer_map is None else layer_map(bp), x,
                         cache_l, ap, ctx, mesh, positions=positions,
                         kv_positions=kv_positions, q_mask=q_mask,
                         block_tbl=block_tbl, kv_ring=kv_ring)
    x = L.apply_norm(x, model.final_norm, ap.cfg)
    return _unranked(L.lm_logits(model.embed, x)[:, :, 0], mesh), cache


# {q, s} leaves (``weight_quant``) the decode step reads through
# ``w8_matmul`` (``layers.rank_matmul``, ``overlap.project``); the rest
# (kernel 7's experts, the conv taps, the channel-mix ``wr`` whose shape
# the layer reads, and under overlap the ``wo``/``wd`` that kernel 5 or
# the collective matmul take) are dequantized a layer at a time.
_W8_READS = {"attn": {"wq", "wk", "wv", "wo"}, "mlp": {"wg", "wu", "wd"},
             "ssm": {"w_x", "w_z", "w_bc", "w_dt", "w_out"},
             "tm": {"w_r", "w_k", "w_v", "w_g", "w_a", "w_b", "w_o"},
             "cm": {"wk", "wv"}}


def w8_keep(ctx: ParallelCtx) -> Callable[[str, str], bool]:
    """The ``keep`` test of the decode step's LayerMap under ``ctx``."""
    overlap = _use_overlap(ctx)

    def keep(group: str, name: str) -> bool:
        if overlap and (group, name) in (("attn", "wo"), ("mlp", "wd")):
            return False
        return name in _W8_READS.get(group, ())

    return keep


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def prefill_chunk(model: DenseLM, cache: Cache, tokens: torch.Tensor,
                  positions: torch.Tensor, ap: ArchPlan,
                  ctx: ParallelCtx = LOCAL, mesh=None, *,
                  slot: Optional[torch.Tensor] = None,
                  return_logits: bool = True
                  ) -> Tuple[Optional[torch.Tensor], Cache]:
    """Chunked prefill, the port of ``prefill_chunk``: C tokens of each
    sequence written into the decode cache at ``positions`` and attended
    causally over everything written so far (``attention_chunk_step``),
    the cache updated in place.

    tokens: (N, C) int; positions: (N, C) int32, contiguous in each row.
    ``slot=None``: batch-wide, N the cache's batch (the speculative verify
    step).  ``slot``: a (1,) int tensor on the device, N = 1, the chunk
    spliced into that row of every rank (the continuous batcher's
    admission); read on the device, so one captured step serves any slot.
    Returns (logits, cache): vocab-sharded logits (R, N, C, V_local) on a
    mesh, (N, C, V_pad) without one; None with ``return_logits=False``
    (intermediate chunks only feed the cache: no final norm, no head).
    The row-parallel projections go through ``_residual_proj`` (overlapped
    under ``ctx.overlap_matmul``, kernel 5 under ``hier_rd``).  An ``ef``
    leaf is zeroed, the slot's or all of it, as in the reference: prefill
    reductions over (N, C, D) chunks take the one-shot rounding, and a
    slot's decode error feedback restarts from zero.  Dense family only:
    recurrent states cannot skip pads and MoE capacity is
    load-dependent."""
    cfg = ap.cfg
    if cfg.family != "dense":
        raise ValueError("chunked prefill supports attention-only dense "
                         f"families, not {cfg.family!r}")
    if "k_scale" in cache:
        raise NotImplementedError("chunked prefill with kv_quant")
    R = check_layout(ap, ctx, mesh)
    N = tokens.shape[0]
    batch = _cache_rows(cache) // R
    if slot is None:
        if N != batch:
            raise ValueError(f"a batch-wide chunk of {N} rows over a cache "
                             f"of {batch}")
        local = torch.arange(N, device=tokens.device)
    else:
        if N != 1:
            raise ValueError(f"slot admission is per request, got N={N}")
        local = slot.long()
    rows = (torch.arange(R, device=tokens.device)[:, None] * batch
            + local[None]).reshape(-1).to(torch.int32)
    if "ef" in cache:      # (L, sites, R, batch, D)
        if slot is None:
            cache["ef"].zero_()
        else:
            cache["ef"].index_fill_(3, local, 0.0)
    block_tbl = cache.get("block_tbl")
    q_mask = _q_mask(ap, tokens.device)
    x = L.embed_lookup(model.embed, tokens, ctx, mesh, ap.vocab_pad)
    for i, bp in enumerate(model.blocks):
        cache_l = {"k": cache["k"][i], "v": cache["v"][i]}
        heads = L.attention_chunk_step(
            bp.attn, L.apply_norm(x, bp.ln1, cfg), cache_l, cfg,
            positions=positions, rows=rows, q_mask=q_mask,
            block_tbl=block_tbl)
        x, _ = _residual_proj(x, heads, bp.attn["wo"], ctx, mesh)
        x, _ = _residual_proj(x, L.mlp_hidden(bp.mlp, L.apply_norm(
            x, bp.ln2, cfg), cfg), L.mlp_down_w(bp.mlp, cfg), ctx, mesh)
    if not return_logits:
        return None, cache
    x = L.apply_norm(x, model.final_norm, cfg)
    return _unranked(L.lm_logits(model.embed, x), mesh), cache


__all__ = ["ArchPlan", "make_plan", "check_layout", "Block", "DenseLM",
           "from_global", "init_params", "block_forward", "forward_lm",
           "ef_sites_for", "fold_table", "init_cache", "seed_cache",
           "block_decode", "decode_step", "prefill_chunk",
           "encoder_forward", "RECURRENT_LEAVES", "KV_LEAVES", "ENC_LEAVES",
           "w8_keep"]
