"""Serve-step builders over the virtual mesh: the port of
``repro/parallel/steps.py::build_prefill`` and ``build_decode_step`` (the
``sample=True`` branch; ``fsdp_serve``, ``weight_quant``, ``kv_quant`` and
``window_cache`` are not ported).

JAX wrapped these in ``shard_map``; here they are thin closures over
(ap, ctx, mesh), kept so a reader finds the counterparts.  Both sample
greedily over the vocab shards (``layers.greedy_sample``), as the
reference's mesh steps do.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.mesh import VirtualMesh
from ..core.pcontext import ParallelCtx
from ..models import layers as L
from ..models.transformer import (ArchPlan, Cache, DenseLM, check_layout,
                                  decode_step, forward_lm, init_cache,
                                  seed_cache)


def build_prefill(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh, *,
                  s_max: int
                  ) -> Callable[[DenseLM, torch.Tensor],
                                Tuple[torch.Tensor, Cache]]:
    """Prefill: (model, tokens (B, S)) -> (first tokens (B,) int32, the
    dense decode cache seeded with the prompt's K/V)."""
    check_layout(ap, ctx, mesh)

    def prefill(model: DenseLM, tokens: torch.Tensor):
        logits, states = forward_lm(model, tokens, ap, ctx, mesh,
                                    collect_state=True)
        cache = init_cache(ap, tokens.shape[0], s_max, device=tokens.device,
                           mesh=mesh)
        seed_cache(cache, states)
        nxt = L.greedy_sample(logits[:, :, -1], ctx, mesh, ap.cfg.vocab_size)
        return nxt, cache

    return prefill


def build_decode_step(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh
                      ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """One-token decode across the batch: (model, cache, tokens, positions)
    -> (next tokens (B,) int32, cache updated in place)."""
    check_layout(ap, ctx, mesh)

    def step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
             positions: torch.Tensor):
        logits, cache = decode_step(model, cache, tokens, positions, ap, ctx,
                                    mesh)
        return L.greedy_sample(logits, ctx, mesh, ap.cfg.vocab_size), cache

    return step


__all__ = ["build_prefill", "build_decode_step"]
