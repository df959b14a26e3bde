"""Serve-step builders over the virtual mesh: the port of
``repro/parallel/steps.py::build_prefill`` and ``build_decode_step`` (the
``sample=True`` branch; ``fsdp_serve``, ``weight_quant``, ``kv_quant`` and
``window_cache`` are not ported).

JAX wrapped these in ``shard_map``; here they are thin closures over
(ap, ctx, mesh), kept so a reader finds the counterparts.  Both sample
greedily over the vocab shards (``layers.greedy_sample``), as the
reference's mesh steps do.  ``ar_table`` (a path, an
:class:`~repro_torch.core.autotune.AutoTuner` or None) is resolved at
build time and every call of the step runs under that tuner, so each
``ar_strategy="auto"`` call site of THIS step resolves against THIS table
(the reference activates it around tracing; the port resolves at every
call).  Under a quantized wire the prefill's cache carries the
error-feedback leaf (``ef_sites_for``), zeroed, which every decode step
consumes and refreshes.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..core import autotune
from ..core.mesh import VirtualMesh
from ..core.pcontext import ParallelCtx
from ..models import layers as L
from ..models.transformer import (ArchPlan, Cache, DenseLM, check_layout,
                                  decode_step, ef_sites_for, forward_lm,
                                  init_cache, seed_cache)


ARTable = Optional[Union[str, autotune.AutoTuner]]


def build_prefill(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh, *,
                  s_max: int, ar_table: ARTable = None
                  ) -> Callable[[DenseLM, torch.Tensor],
                                Tuple[torch.Tensor, Cache]]:
    """Prefill: (model, tokens (B, S)) -> (first tokens (B,) int32, the
    dense decode cache seeded with the prompt's K/V and, under a quantized
    wire, a zero error-feedback leaf)."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    ef_sites = ef_sites_for(ctx, ap.cfg)

    def prefill(model: DenseLM, tokens: torch.Tensor):
        with autotune.using(tuner):
            logits, states = forward_lm(model, tokens, ap, ctx, mesh,
                                        collect_state=True)
        cache = init_cache(ap, tokens.shape[0], s_max, device=tokens.device,
                           mesh=mesh, ef_sites=ef_sites)
        seed_cache(cache, states)
        nxt = L.greedy_sample(logits[:, :, -1], ctx, mesh, ap.cfg.vocab_size)
        return nxt, cache

    return prefill


def build_decode_step(ap: ArchPlan, ctx: ParallelCtx, mesh: VirtualMesh, *,
                      ar_table: ARTable = None
                      ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """One-token decode across the batch: (model, cache, tokens, positions)
    -> (next tokens (B,) int32, cache updated in place)."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)

    def step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
             positions: torch.Tensor):
        with autotune.using(tuner):
            logits, cache = decode_step(model, cache, tokens, positions, ap,
                                        ctx, mesh)
        return L.greedy_sample(logits, ctx, mesh, ap.cfg.vocab_size), cache

    return step


__all__ = ["build_prefill", "build_decode_step"]
