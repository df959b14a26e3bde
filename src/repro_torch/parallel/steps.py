"""Serve-step builders, at tp=1 (``mesh=None``) and over the virtual mesh:
the port of ``repro/parallel/steps.py::build_prefill``,
``build_decode_step``, ``build_cache_init``, ``build_serve_step`` and
``build_admit_step`` (``fsdp_serve``, ``weight_quant``, ``kv_quant`` and
``window_cache`` are not ported; the chunked admission step is ROADMAP
item 6b, the speculative verify step item 7, the prefill-only and KV
splice steps item 8).

JAX wrapped these in ``shard_map`` and compiled them once with ``jit``;
here they are closures over (ap, ctx, mesh), and the compiled step's
counterpart on the card is a CUDA graph (:class:`CapturedStep`): a
fixed-shape step (the decode step of ``InferenceEngine.generate``, the
batcher's serve step) runs eagerly once, is captured on its second call
and replayed after.  ``ar_table`` (a path, an
:class:`~repro_torch.core.autotune.AutoTuner` or None) is resolved at
build time and every call of the step runs under that tuner, so each
``ar_strategy="auto"`` call site of THIS step resolves against THIS table:
at every call of an eager step, once at the capture of a graph (as the
reference resolves it at trace time).  Under a quantized wire the cache
carries the error-feedback leaf (``ef_sites_for``), zeroed when a prompt
is seeded, which every decode step consumes and refreshes.

Sampling: greedy over the vocab shards (``layers.greedy_sample``) at
temperature 0; else the vocab shards are gathered and each row draws from
its own stateless chain (``layers.sample_token``: base key, token index),
the counterpart of the reference's ``fold_in(keys[s], idx[s])``, so a
request's stream depends on neither the schedule nor the other slots, and
a graph replays it with no generator state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core import autotune
from ..core.pcontext import ParallelCtx
from ..models import layers as L
from ..models.transformer import (ArchPlan, Cache, DenseLM, check_layout,
                                  decode_step, ef_sites_for, forward_lm,
                                  init_cache, seed_cache)


ARTable = Optional[Union[str, autotune.AutoTuner]]
State = Dict[str, torch.Tensor]


class CapturedStep:
    """``body()`` — a step that reads and writes only tensors that outlive
    it (weights, cache, static inputs and outputs), in place — run eagerly
    on its first call, captured as a CUDA graph on its second and replayed
    from then on, or eagerly on every call with ``graph=False``.  The eager
    first call is the warm-up the capture needs: it builds the kernels
    (nvcc at the first launch), runs the wrappers' per-shape checks and
    grows the exchange workspaces to the step's shapes, so nothing is
    built, checked on the host against the device or reallocated while the
    graph is captured.  When an eager call outside the step (a longer
    prompt's prefill) has since grown a buffer of ``workspace`` (the
    mesh's :class:`~repro_torch.kernels.rd_allreduce.ops.RDWorkspace`) that
    the graph took, the step is captured anew before it replays
    (``recaptures``): a graph never runs on freed buffers.  A capture or
    replay that fails raises; nothing goes back to the eager form."""

    def __init__(self, body: Callable[[], None], graph: bool,
                 workspace=None):
        self.body = body
        self.graph = graph
        self.workspace = workspace
        self.calls = 0
        self.replays = 0
        self.recaptures = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._generation = 0

    def __call__(self) -> None:
        self.calls += 1
        if not self.graph or self.calls == 1:
            self.body()
            return
        gen = self.workspace.generation if self.workspace is not None else 0
        if self._graph is not None and gen != self._generation:
            self._graph = None
            self.recaptures += 1
        if self._graph is None:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self.body()
            self._graph, self._generation = g, gen
        self._graph.replay()
        self.replays += 1


def _ranked(logits: torch.Tensor, mesh) -> torch.Tensor:
    """Logits with the rank axis: (R, B, V_local) on a mesh, (1, B, V_pad)
    at tp=1."""
    return logits if mesh is not None else logits[None]


def _full_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded logits (R, B, V_local) gathered to the full vocab
    (B, R * V_local), global id = rank * V_local + local id: the one
    gather every sampled path goes through."""
    R, B, V = logits.shape
    return logits.permute(1, 0, 2).reshape(B, R * V)


def _sample_next(logits: torch.Tensor, ctx: ParallelCtx, mesh, cfg,
                 keys: Optional[torch.Tensor], idx: Optional[torch.Tensor],
                 temperature: float, top_k: int) -> torch.Tensor:
    """Next token (B,) int32 from one position's logits ((B, V_pad) at
    tp=1, (R, B, V_local) on a mesh): the sharded greedy argmax at
    temperature 0, else the vocab gathered and row b's chain ``keys[b]``
    at token ``idx[b]``."""
    lr = _ranked(logits, mesh)
    if temperature <= 0.0:
        return L.greedy_sample(lr, ctx, mesh, cfg.vocab_size)
    return L.sample_token(_full_vocab(lr), keys, idx,
                          temperature=temperature, top_k=top_k,
                          vocab_real=cfg.vocab_size)


def _finite_slots(logits: torch.Tensor, mesh) -> torch.Tensor:
    """(B,) bool: every logit of the row finite on every rank's shard (the
    device half of the reference's quarantine guard)."""
    bad = ~torch.isfinite(_ranked(logits, mesh).float())
    return bad.sum(dim=(0, 2)) == 0


def build_cache_init(ap: ArchPlan, ctx: ParallelCtx, mesh, *, slots: int,
                     s_max: int, block_size: int = 0,
                     n_blocks: Optional[int] = None,
                     device: torch.device | str) -> Callable[[], Cache]:
    """() -> the zeroed decode cache of ``slots`` rows (paged when
    ``block_size > 0``, a pool of ``n_blocks`` a rank), with the EF leaf
    when the ctx may quantize the wire."""
    check_layout(ap, ctx, mesh)
    ef_sites = ef_sites_for(ctx, ap.cfg)

    def init() -> Cache:
        return init_cache(ap, slots, s_max, block_size=block_size,
                          n_blocks=n_blocks, device=device, mesh=mesh,
                          ef_sites=ef_sites)

    return init


def build_prefill(ap: ArchPlan, ctx: ParallelCtx, mesh, *, s_max: int,
                  block_size: int = 0, temperature: float = 0.0,
                  top_k: int = 0, ar_table: ARTable = None
                  ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """Prefill: (model, tokens (B, S), keys (B, 2) or None, cache=None) ->
    (first tokens (B,) int32, the decode cache seeded with the prompt's
    states).  Without a ``cache`` a new one is made (dense or paged with
    the identity table, and, under a quantized wire, a zero error-feedback
    leaf); a given one is seeded in place.  The first token is token 0 of
    each row's chain."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    ef_sites = ef_sites_for(ctx, ap.cfg)

    def prefill(model: DenseLM, tokens: torch.Tensor,
                keys: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None):
        with autotune.using(tuner):
            logits, states = forward_lm(model, tokens, ap, ctx, mesh,
                                        collect_state=True)
        if cache is None:
            cache = init_cache(ap, tokens.shape[0], s_max,
                               block_size=block_size, device=tokens.device,
                               mesh=mesh, ef_sites=ef_sites)
        seed_cache(cache, states)
        idx = torch.zeros(tokens.shape[0], dtype=torch.int32,
                          device=tokens.device)
        nxt = _sample_next(logits[..., -1, :], ctx, mesh, ap.cfg, keys, idx,
                           temperature, top_k)
        return nxt, cache

    return prefill


def build_decode_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                      temperature: float = 0.0, top_k: int = 0,
                      ar_table: ARTable = None
                      ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """One-token decode across the batch: (model, cache, tokens,
    positions, keys=None, idx=None) -> (next tokens (B,) int32, cache
    updated in place); a sampled step draws token ``idx[b]`` of row b's
    chain ``keys[b]``.  Capture-safe: no host sync, no host-to-device
    copy, no allocation outside the caching allocator."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)

    def step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
             positions: torch.Tensor, keys: Optional[torch.Tensor] = None,
             idx: Optional[torch.Tensor] = None):
        with autotune.using(tuner):
            logits, cache = decode_step(model, cache, tokens, positions, ap,
                                        ctx, mesh)
        return _sample_next(logits, ctx, mesh, ap.cfg, keys, idx,
                            temperature, top_k), cache

    return step


def build_serve_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                     model: DenseLM, cache: Cache, state: State, s_max: int,
                     temperature: float = 0.0, top_k: int = 0,
                     ar_table: ARTable = None, cuda_graph: bool = True
                     ) -> Tuple[CapturedStep, torch.Tensor]:
    """The batcher's step over ``model``, ``cache`` and ``state`` =
    {tokens, positions, remaining: (slots,) int32, active: (slots,) bool,
    rng: (slots, 2) int64 per-request chain keys, sample_idx: (slots,)
    int32 tokens sampled so far}, whose contents the caller updates in
    place: (step, out).  ``step()`` decodes every slot, samples (slot s
    draws token ``sample_idx[s]`` of its chain ``rng[s]``), advances the
    state in place and writes the int32 (3, slots) ``out``, one host read a
    step: ``emitted`` holds the sampled token where active and the stale
    token elsewhere, ``done`` flags slots that finished this step,
    ``finite`` slots whose logits were all finite.  Inactive slots keep
    decoding into their own dense row or their rank's trash block (paged):
    no masking in the hot path.  With ``cuda_graph`` a step on CUDA
    tensors is captured on its second call and replayed after; on the CPU
    it is eager."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    st = state
    out = torch.zeros((3, st["tokens"].shape[0]), dtype=torch.int32,
                      device=st["tokens"].device)

    def body():
        with torch.inference_mode(), autotune.using(tuner):
            logits, _ = decode_step(model, cache, st["tokens"],
                                    st["positions"], ap, ctx, mesh)
            nxt = _sample_next(logits, ctx, mesh, ap.cfg, st["rng"],
                               st["sample_idx"], temperature, top_k)
            finite = _finite_slots(logits, mesh)
            active = st["active"]
            emitted = torch.where(active, nxt, st["tokens"])
            act_i = active.to(torch.int32)
            positions = st["positions"] + act_i
            remaining = st["remaining"] - act_i
            done = active & ((remaining <= 0) | (positions >= s_max - 1))
            st["active"].copy_(active & ~done)
            st["tokens"].copy_(emitted)
            st["positions"].copy_(positions)
            st["remaining"].copy_(remaining)
            st["sample_idx"].add_(act_i)
            out[0].copy_(emitted)
            out[1].copy_(done)
            out[2].copy_(finite)

    step = CapturedStep(body, cuda_graph and out.is_cuda,
                        workspace=getattr(mesh, "workspace", None))
    return step, out


def build_admit_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                     temperature: float = 0.0, top_k: int = 0,
                     ar_table: ARTable = None
                     ) -> Callable[..., torch.Tensor]:
    """Full-prefill admission, eager (its shape follows the prompt, as the
    reference compiles one executable a length): (model, cache, prompt
    (1, S), slot, key (1, 2)) -> the first token (1,) int32, token 0 of
    the request's chain, with the prompt's K/V and recurrent states
    spliced into row ``slot`` of every rank and the slot's EF zeroed."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)

    def admit(model: DenseLM, cache: Cache, prompt: torch.Tensor, slot: int,
              key: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), autotune.using(tuner):
            logits, states = forward_lm(model, prompt, ap, ctx, mesh,
                                        collect_state=True)
            seed_cache(cache, states, slot=slot)
            idx = torch.zeros(1, dtype=torch.int32, device=prompt.device)
            return _sample_next(logits[..., -1, :], ctx, mesh, ap.cfg, key,
                                idx, temperature, top_k)

    return admit


__all__ = ["CapturedStep", "build_cache_init", "build_prefill",
           "build_decode_step", "build_serve_step", "build_admit_step"]
