"""Pipeline parallelism, the paper's HP scheme (TP inside a node x PP
across nodes): the port of ``repro/parallel/pp.py``, a GPipe prefill
forward over the virtual mesh.

The mesh's slow axis is the stage axis (``VirtualMesh(pods=P, fast=F)``,
``stage_axis="pod"``) and the ctx's TP axes are the fast axis alone
(``tp_fast=("model",)``, ``ep=("model",)``), so TP runs inside each stage
through the same collectives as everywhere else, each stage's F ranks a
group of their own (``hierarchical._groups``).  The model is in the stage
layout (``sharding.stage_layout``): rank (s, f) holds global layer
``s * L / P + j`` as its j-th block, cut f, so one call of a block runs
that block of every stage at once on the rank-folded batch, which
carries every stage's buffer.  A forward makes ``(L / P) x (M + P - 1)``
block calls, each one launch of kernel 3 (flash attention).

The schedule is the reference's: the embedding runs on every stage;
over ``M + P - 1`` ticks stage 0 takes in microbatch t while t < M, every
stage runs its ``L / P`` layers on its buffer, the last stage's finished
microbatch ``t - (P - 1)`` is collected, and the buffers shift one stage
forward (``lax.ppermute``, here a roll of the (P, F, ...) rank view).
Bubble ticks run on zeros or on stale buffers and are never collected.
At the end the last stage's outputs are summed over the stages
(``lax.psum``, the other stages contributing zeros), and every stage
applies the final norm and its vocab shard of the head.  Blocks run
causal over positions ``0..S-1`` with no sequence parallelism.

Only token prompts go in, as in the reference: the encoder-decoder and
VLM families raise.  The quantized wire (``ar_quant``, ``quant_ag``) and
the overlapped projections are refused (ROADMAP §3).  Decode-side HP is
modelled (:mod:`repro_torch.inference.simulator`), not run, as in the
reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.mesh import VirtualMesh
from ..core.pcontext import ParallelCtx
from ..models import layers as L
from ..models.transformer import ArchPlan, DenseLM, _q_mask, block_forward
from .sharding import stage_layout


def check_pp_layout(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh,
                    stage_axis: str) -> int:
    """Raise ``ValueError`` unless (ap, ctx, mesh) describe a pipeline over
    ``stage_axis``: the mesh's slow axis, no TP axis of the ctx (the one
    axis of size > 1 that ``VirtualMesh.check_ctx`` lets through besides
    the TP axes), the plan at tp = the fast size, a token-only family, a
    layer count the stages divide, and none of the knobs the pipeline
    does not take.  Returns the stage count."""
    cfg = ap.cfg
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(f"{cfg.name}: the pipeline forward takes tokens "
                         f"only; the {cfg.family} family needs frames or "
                         "patches")
    if ctx.dp or ctx.fsdp or ctx.sp:
        raise ValueError(f"ctx dp={ctx.dp} fsdp={ctx.fsdp} sp={ctx.sp}: "
                         "the pipeline's mesh holds its stages and TP axes "
                         "only")
    if ctx.ar_quant != "none" or ctx.quant_ag or ctx.overlap_matmul:
        raise ValueError("the pipeline forward runs the full-precision "
                         "wire without overlapped projections (ar_quant="
                         f"{ctx.ar_quant!r}, quant_ag={ctx.quant_ag}, "
                         f"overlap_matmul={ctx.overlap_matmul})")
    mesh.check_ctx(ctx, stage_axis=stage_axis)
    if ap.tp != mesh.fast:
        raise ValueError(f"plan tp={ap.tp}: a stage's TP group is the fast "
                         f"axis, {mesh.fast} ranks")
    stages = mesh.axis_size(stage_axis)
    if cfg.n_layers % stages:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                         f"divisible by {stages} pipeline stages")
    return stages


def to_stages(model: DenseLM, mesh: VirtualMesh) -> DenseLM:
    """A model cut over the fast axis alone (``n_ranks`` = F, e.g.
    ``init_params`` at tp = F on ``VirtualMesh(1, F)``) re-laid into the
    stage layout of ``mesh`` (P x F ranks)."""
    if model.n_ranks != mesh.fast:
        raise ValueError(f"a model of {model.n_ranks} ranks is not cut over "
                         f"the fast axis ({mesh.fast} ranks)")

    def group(m):
        return dict(m.items())

    cut = {"embed": group(model.embed), "final_norm": group(model.final_norm),
           "blocks": [{**{n: group(g) for n, g in b.named_children()},
                       **dict(b.named_parameters(recurse=False))}
                      for b in model.blocks]}
    t = stage_layout(cut, mesh.pods)
    return DenseLM(t["embed"], t["blocks"], t["final_norm"])


def _shift(buf: torch.Tensor, stages: int) -> torch.Tensor:
    """The reference's ``lax.ppermute`` over ``i -> i + 1 mod P``: stage
    s's buffer (R, ...) moves to stage s + 1."""
    return buf.reshape(stages, -1, *buf.shape[1:]).roll(1, 0).reshape(
        buf.shape)


def _finished(t: int, stages: int, microbatches: int) -> Optional[int]:
    """The microbatch the last stage finishes at tick t, ``t - (P - 1)``,
    or None while the pipeline fills."""
    i = t - (stages - 1)
    return i if 0 <= i < microbatches else None


def build_pp_forward(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh, *,
                     stage_axis: str, microbatches: int) -> Callable:
    """``fn(model, tokens)``: tokens (B, S) to the vocab-sharded logits
    (R, B, S, V_local), rank (s, f) holding shard f (the same on every
    stage), pipelined over ``stage_axis``.  The model is in this mesh's
    stage layout (:func:`to_stages`).  Requirements, each a
    ``ValueError``: those of :func:`check_pp_layout`, and at the call a
    batch that the ``microbatches`` divide and a model in that layout."""
    stages = check_pp_layout(ap, ctx, mesh, stage_axis)
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} must be >= 1")
    per = ap.cfg.n_layers // stages

    def fn(model: DenseLM, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        if B % microbatches:
            raise ValueError(f"batch {B} is not divisible by "
                             f"{microbatches} microbatches")
        if model.n_ranks != mesh.size or len(model.blocks) != per:
            raise ValueError(f"the model holds {len(model.blocks)} blocks "
                             f"on {model.n_ranks} ranks; the stage layout "
                             f"of this mesh is {per} on {mesh.size}")
        R, mb = mesh.size, B // microbatches
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        q_mask = _q_mask(ap, tokens.device)
        if q_mask is not None:
            q_mask = q_mask.repeat(stages, 1)
        x = L.embed_lookup(model.embed, tokens, ctx, mesh, ap.vocab_pad)
        x_mbs = x.reshape(R, microbatches, mb, *x.shape[2:])
        buf = torch.zeros_like(x_mbs[:, 0])
        out = torch.zeros_like(x_mbs)
        first, last = slice(0, mesh.fast), slice(R - mesh.fast, R)
        for t in range(microbatches + stages - 1):
            if t < microbatches:
                buf[first] = x_mbs[first, t]
            for bp in model.blocks:
                buf, _ = block_forward(bp, buf, ap, ctx, mesh,
                                       positions=positions, q_mask=q_mask)
            done = _finished(t, stages, microbatches)
            if done is not None:
                out[last, done] = buf[last]
            buf = _shift(buf, stages)
        # the last stage's outputs on every stage (the reference's psum;
        # every other stage's ``out`` is zero)
        x = out.reshape(stages, -1, *out.shape[1:]).sum(0, keepdim=True)
        x = x.expand(stages, *x.shape[1:]).reshape(R, B, *x.shape[4:])
        x = L.apply_norm(x, model.final_norm, ap.cfg)
        return L.lm_logits(model.embed, x)

    return fn


__all__ = ["build_pp_forward", "check_pp_layout", "to_stages"]
