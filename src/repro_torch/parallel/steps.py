"""Step builders, at tp=1 (``mesh=None``) and over the virtual mesh.

The train step (:func:`build_train_step`, the reference's, for the dense
family at tp=1, alone or data-parallel over the pods of a
``VirtualMesh(pods, 1)``: ROADMAP item 11's first part) is a
:class:`TrainStep`; the rest of this module is the serve steps.

Serve-step builders:
the port of ``repro/parallel/steps.py::build_prefill``,
``build_decode_step``, ``build_cache_init``, ``build_serve_step``,
``build_admit_step``, ``build_admit_chunk_step``,
``build_spec_verify_step``, and the disaggregated pools'
``build_prefill_only_step`` and ``build_kv_splice_step`` (``fsdp_serve``
is not ported).  ``build_decode_step`` takes the reference's
``weight_quant`` (int8 block weights read through ``w8_matmul``, the
others dequantized a layer at a time, :class:`~repro_torch.parallel.quant.
LayerMap`), ``kv_quant`` (the int8 cache, which ``build_cache_init`` makes)
and ``window_cache`` (the ring-buffer window cache).

JAX wrapped these in ``shard_map`` and compiled them once with ``jit``;
here they are closures over (ap, ctx, mesh), and the compiled step's
counterpart on the card is a CUDA graph (:class:`CapturedStep`): a
fixed-shape step (the decode step of ``InferenceEngine.generate``, the
batcher's serve step, its chunked admission steps, the speculative verify
step of each k) runs eagerly once, is captured on its second call and
replayed after.  ``ar_table`` (a path, an
:class:`~repro_torch.core.autotune.AutoTuner` or None) is resolved at
build time and every call of the step runs under that tuner, so each
``ar_strategy="auto"`` call site of THIS step resolves against THIS table:
at every call of an eager step, once at the capture of a graph (as the
reference resolves it at trace time).  The prefill-shaped steps
(``build_prefill``, ``build_admit_step``, ``build_prefill_only_step``)
run ``forward_lm`` with ``sp=None``, so ``ctx.seq_parallel`` ("auto"
included) is resolved per call under the same tuner; the decode, chunked
admission and verify steps never decompose (``decode_step`` and
``prefill_chunk`` have no sequence-parallel form, as the reference builds
them with ``sp=False``).  Under a quantized wire the cache
carries the error-feedback leaf (``ef_sites_for``), zeroed when a prompt
is seeded, which every decode step consumes and refreshes.

Sampling: greedy over the vocab shards (``layers.greedy_sample``) at
temperature 0; else the vocab shards are gathered and each row draws from
its own stateless chain (``layers.sample_token``: base key, token index),
the counterpart of the reference's ``fold_in(keys[s], idx[s])``, so a
request's stream depends on neither the schedule nor the other slots, and
a graph replays it with no generator state.  The speculative verify step
draws its acceptance uniforms and its corrections from the same chains.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core import autotune
from ..core import hierarchical as hier
from ..core.pcontext import LOCAL, ParallelCtx
from ..core.tree import tree_items, tree_leaves, tree_map
from ..models import layers as L
from ..models.bridge import stack_layers, unstack_layers
from ..models.transformer import (ArchPlan, Cache, DenseLM, check_layout,
                                  decode_step, ef_sites_for, forward_lm,
                                  init_cache, params_tree, prefill_chunk,
                                  seed_cache, to_global, trainable, w8_keep)
from ..training.optimizer import adamw_update, cosine_lr, global_grad_norm
from .quant import LayerMap
from .sharding import repl_factors


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
        self.captures = 0
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
            # no garbage collection while capturing: a collected cycle
            # holding another CUDA graph would reset it mid-capture, which
            # invalidates the capture
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(g):
                    self.body()
            finally:
                if gc_on:
                    gc.enable()
            self._graph, self._generation = g, gen
            self.captures += 1
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
    """(B,) bool: every logit of the row (of each of its positions) finite
    on every rank's shard (the device half of the reference's quarantine
    guard)."""
    bad = ~torch.isfinite(_ranked(logits, mesh).float())
    return bad.flatten(2).sum(dim=(0, 2)) == 0


def build_cache_init(ap: ArchPlan, ctx: ParallelCtx, mesh, *, slots: int,
                     s_max: int, block_size: int = 0,
                     n_blocks: Optional[int] = None, kv_quant: bool = False,
                     device: torch.device | str) -> Callable[[], Cache]:
    """() -> the zeroed decode cache of ``slots`` rows (paged when
    ``block_size > 0``, a pool of ``n_blocks`` a rank; int8 with its
    scales under ``kv_quant``), with the EF leaf when the ctx may quantize
    the wire."""
    check_layout(ap, ctx, mesh)
    ef_sites = ef_sites_for(ctx, ap.cfg)

    def init() -> Cache:
        return init_cache(ap, slots, s_max, block_size=block_size,
                          n_blocks=n_blocks, device=device, mesh=mesh,
                          ef_sites=ef_sites, kv_quant=kv_quant)

    return init


def build_prefill(ap: ArchPlan, ctx: ParallelCtx, mesh, *, s_max: int,
                  block_size: int = 0, temperature: float = 0.0,
                  top_k: int = 0, ar_table: ARTable = None
                  ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """Prefill: (model, tokens (B, S), keys (B, 2) or None, cache=None,
    frame_embeds=None, patch_embeds=None) -> (first tokens (B,) int32, the
    decode cache seeded with the prompt's states).  Without a ``cache`` a
    new one is made (dense or paged with the identity table, and, under a
    quantized wire, a zero error-feedback leaf); a given one is seeded in
    place, an encoder-decoder's cross K/V included, so a decode step
    captured over it reads the new batch's.  The first token is token 0 of
    each row's chain.  ``frame_embeds`` (B, T, D) / ``patch_embeds`` (B,
    P, D): an encoder-decoder's frames and a VLM's patches, on the
    tokens' device, the same on every rank (``forward_lm``)."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    ef_sites = ef_sites_for(ctx, ap.cfg)

    def prefill(model: DenseLM, tokens: torch.Tensor,
                keys: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, *,
                frame_embeds: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None):
        with autotune.using(tuner):
            logits, states = forward_lm(model, tokens, ap, ctx, mesh,
                                        collect_state=True,
                                        frame_embeds=frame_embeds,
                                        patch_embeds=patch_embeds)
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
                      ar_table: ARTable = None, kv_quant: bool = False,
                      weight_quant: bool = False,
                      window_cache: bool = False
                      ) -> Callable[..., Tuple[torch.Tensor, Cache]]:
    """One-token decode across the batch: (model, cache, tokens,
    positions, keys=None, idx=None) -> (next tokens (B,) int32, cache
    updated in place); a sampled step draws token ``idx[b]`` of row b's
    chain ``keys[b]``.  Capture-safe: no host sync, no host-to-device
    copy, no allocation outside the caching allocator.

    ``weight_quant``: ``model`` is a ``quant.quantize_model`` model; the
    step's LayerMap (made here, its buffers at the first call) dequantizes
    the leaves no ``w8_matmul`` reads.  ``kv_quant``: the cache is
    ``build_cache_init(kv_quant=True)``'s (the layout selects the path;
    the flag is the reference's).  ``window_cache``: the cache is
    ``init_cache(window_cache=True)``'s ring."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    layer_map = LayerMap(w8_keep(ctx), ap.cfg.dtype) if weight_quant \
        else None

    def step(model: DenseLM, cache: Cache, tokens: torch.Tensor,
             positions: torch.Tensor, keys: Optional[torch.Tensor] = None,
             idx: Optional[torch.Tensor] = None):
        if kv_quant != ("k_scale" in cache) and "k" in cache:
            raise ValueError(f"kv_quant={kv_quant} over a cache "
                             f"{'with' if 'k_scale' in cache else 'without'}"
                             " int8 scales")
        with autotune.using(tuner):
            logits, cache = decode_step(model, cache, tokens, positions, ap,
                                        ctx, mesh, layer_map=layer_map,
                                        kv_ring=window_cache)
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


def build_prefill_only_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                            temperature: float = 0.0, top_k: int = 0,
                            ar_table: ARTable = None
                            ) -> Callable[..., Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]]:
    """The prefill pool's step of disaggregated serving, eager: (model,
    prompt (1, S), key (1, 2)) -> (first token (1,) int32, k, v), the
    prompt run through ``forward_lm`` under this pool's tuner, its first
    token sampled as token 0 of the chain ``key`` (the same function as
    ``build_admit_step``'s), and its per-layer K/V handed back in the
    folded per-rank layout (L, R, S, u, hd) with no cache written: the raw
    material of a :class:`~repro_torch.inference.kv_cache.KVBundle`.
    Dense family only (recurrent states are not handed off)."""
    if ap.cfg.family != "dense":
        raise ValueError("disaggregated prefill is attention-only: dense "
                         f"families only, not {ap.cfg.family!r}")
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)

    def prefill_only(model: DenseLM, prompt: torch.Tensor,
                     key: torch.Tensor):
        with torch.inference_mode(), autotune.using(tuner):
            logits, states = forward_lm(model, prompt, ap, ctx, mesh,
                                        collect_state=True)
            idx = torch.zeros(1, dtype=torch.int32, device=prompt.device)
            nxt = _sample_next(logits[..., -1, :], ctx, mesh, ap.cfg, key,
                               idx, temperature, top_k)
        return nxt, states["k"], states["v"]

    return prefill_only


def build_kv_splice_step(ap: ArchPlan, ctx: ParallelCtx, mesh
                         ) -> Callable[..., Cache]:
    """The decode pool's import of a KV handoff: (cache, k, v, slot) ->
    cache, the states (L, R, T, u, hd) in THIS pool's folded layout
    (``kv_cache.bundle_states`` expands a bundle's real heads into its GQA
    slots) written into row ``slot`` of every rank, dense or through the
    folded block table (the caller has grown the slot's blocks to cover
    [0, T + 1)), and the slot's EF zeroed: ``transformer.seed_cache``,
    the colocated admission's splice.  The writes go into the cache's own
    tensors, on the current stream, so a captured serve step reads them."""
    check_layout(ap, ctx, mesh)

    def splice(cache: Cache, k: torch.Tensor, v: torch.Tensor,
               slot: int) -> Cache:
        with torch.inference_mode():
            return seed_cache(cache, {"k": k, "v": v}, slot=slot)

    return splice


def build_admit_chunk_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                           model: DenseLM, cache: Cache, chunk: int,
                           inputs: Optional[State] = None,
                           sample: bool = True, temperature: float = 0.0,
                           top_k: int = 0, ar_table: ARTable = None,
                           cuda_graph: bool = True
                           ) -> Tuple[CapturedStep, State]:
    """Chunked-prefill admission over ``model`` and ``cache``: one step
    feeds ``chunk`` prompt tokens into one slot's rows of every rank
    (``transformer.prefill_chunk`` with ``slot``), whatever the prompt's
    length.  Returns (step, inputs): ``inputs`` = {tokens (1, chunk)
    int64, positions (1, chunk) int32, slot (1,) int32, last (1,) int64,
    key (1, 2) int64, out (1,) int32} are device tensors the caller fills
    in place before each call (pass one step's ``inputs`` to the other
    form's builder to share them).  ``sample=True`` (the final chunk):
    ``out`` gets the first token, token 0 of the request's chain ``key``,
    sampled from the logits at in-chunk index ``last``; ``sample=False``
    (the intermediate chunks) skips the final norm, the head and the
    sampling.  With ``cuda_graph`` a step on CUDA tensors is captured on
    its second call and replayed after, captured anew when a later eager
    call grew a workspace buffer the graph holds."""
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    if inputs is None:
        dev = cache["k"].device
        inputs = {
            "tokens": torch.zeros((1, chunk), dtype=torch.int64, device=dev),
            "positions": torch.zeros((1, chunk), dtype=torch.int32,
                                     device=dev),
            "slot": torch.zeros(1, dtype=torch.int32, device=dev),
            "last": torch.zeros(1, dtype=torch.int64, device=dev),
            "key": torch.zeros((1, 2), dtype=torch.int64, device=dev),
            "out": torch.zeros(1, dtype=torch.int32, device=dev)}
    x = inputs

    def body():
        with torch.inference_mode(), autotune.using(tuner):
            logits, _ = prefill_chunk(model, cache, x["tokens"],
                                      x["positions"], ap, ctx, mesh,
                                      slot=x["slot"], return_logits=sample)
            if not sample:
                return
            last = _ranked(logits, mesh).index_select(2, x["last"])[:, :, 0]
            x["out"].copy_(_sample_next(
                last if mesh is not None else last[0], ctx, mesh, ap.cfg,
                x["key"], torch.zeros_like(x["slot"]), temperature, top_k))

    step = CapturedStep(body, cuda_graph and x["out"].is_cuda,
                        workspace=getattr(mesh, "workspace", None))
    return step, inputs


def _spec_targets(logits: torch.Tensor, drafts: torch.Tensor, ctx, mesh,
                  cfg, keys: torch.Tensor, idx: torch.Tensor,
                  temperature: float, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The verify pass's target tokens and accept mask, the port of
    ``_spec_targets``.  logits: the C = k + 1 chunk positions' vocab-
    sharded scores ((B, C, V_pad) at tp=1, (R, B, C, V_local) on a mesh);
    drafts (B, k).  Returns (tgt (B, C) int32, match (B, k) bool):
    ``tgt[:, j]`` is the target token emitted at position j if j is the
    first rejection (or the bonus position j == k), ``match[:, j]``
    accepts draft j.

    Greedy: the sharded argmax, a draft matching iff it equals it, so the
    emitted stream is the plain greedy stream.  Sampled, the reference's
    exact rejection rule for deterministic drafts: accept draft d with
    probability p(d), else draw from p with d removed; the bonus draws
    from p.  Position j of slot b draws from token ``idx[b] + j`` of its
    own chain ``keys[b]``: the Gumbel noise of ``layers.sample_token`` over
    the vocabulary, and the acceptance uniform from the same hash row's
    next column."""
    lr = _ranked(logits, mesh)
    R, B, C = lr.shape[:3]
    k = C - 1
    if temperature <= 0.0:
        tgt = L.greedy_sample(lr.reshape(R, B * C, -1), ctx, mesh,
                              cfg.vocab_size).reshape(B, C)
        return tgt, drafts == tgt[:, :k]
    lf = lr.permute(1, 2, 0, 3).reshape(B, C, -1).float()
    V = lf.shape[-1]
    lf = torch.where(torch.arange(V, device=lf.device) < cfg.vocab_size, lf,
                     torch.full((), L.NEG_INF, device=lf.device))
    lf = lf / temperature
    if 0 < top_k < V:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf >= kth, lf,
                         torch.full((), L.NEG_INF, device=lf.device))
    p = torch.softmax(lf, dim=-1)
    tok_idx = idx[:, None] + torch.arange(C, dtype=idx.dtype,
                                          device=idx.device)
    u = L._uniforms(keys.repeat_interleave(C, 0), tok_idx.reshape(-1),
                    V + 1).reshape(B, C, V + 1)
    gumbel = -torch.log(-torch.log(u[..., :V]))
    d = drafts.long()
    match = u[:, :k, V] < p[:, :k].gather(-1, d[..., None])[..., 0]
    resid = lf[:, :k].scatter(-1, d[..., None], L.NEG_INF)
    corr = torch.argmax(resid + gumbel[:, :k], dim=-1)
    bonus = torch.argmax(lf[:, k] + gumbel[:, k], dim=-1)
    return torch.cat([corr, bonus[:, None]], 1).to(torch.int32), match


def build_spec_verify_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                           model: DenseLM, cache: Cache, state: State,
                           k: int, temperature: float = 0.0, top_k: int = 0,
                           ar_table: ARTable = None, cuda_graph: bool = True
                           ) -> Tuple[CapturedStep, torch.Tensor,
                                      torch.Tensor]:
    """The speculative verify step of length ``k`` over ``model``,
    ``cache`` and ``state`` = {tokens, positions, rng, sample_idx} (the
    batcher's serve state, or the engine's decode loop): (step, drafts,
    out).  The caller fills ``drafts`` (B, k) int32 in place; ``step()``
    runs the C = k + 1 chunk ``[tokens, drafts]`` of every row at
    ``positions + [0..k]`` through ``prefill_chunk`` (one launch of
    kernel 3's chunk form a layer for all rows) and writes the int32
    (B, C + 2) ``out``: ``out[:, :C]`` the emitted tokens (the verified
    drafts, then the correction or bonus token: take ``accepted + 1``),
    ``out[:, C]`` accepted (0..k), ``out[:, C + 1]`` whether the row's
    logits were all finite.  The state is not advanced: the caller takes
    a variable number of tokens a row and rolls the rejected tail back.
    Dense family only (``prefill_chunk``); the K/V writes past a row's
    accepted prefix are stale and are overwritten before anything reads
    them (paged: ``BlockAllocator.truncate`` returns their blocks)."""
    if ap.cfg.family != "dense":
        raise ValueError("speculative verify rides the chunked-prefill "
                         f"path: dense families only, not {ap.cfg.family!r}")
    if k < 1:
        raise ValueError(f"spec k must be >= 1, got {k}")
    check_layout(ap, ctx, mesh)
    tuner = autotune.tuner_for(ar_table)
    C = k + 1
    st = state
    B, dev = st["tokens"].shape[0], st["tokens"].device
    drafts = torch.zeros((B, k), dtype=torch.int32, device=dev)
    out = torch.zeros((B, C + 2), dtype=torch.int32, device=dev)
    steps = torch.arange(C, dtype=torch.int32, device=dev)

    def body():
        with torch.inference_mode(), autotune.using(tuner):
            x = torch.cat([st["tokens"][:, None], drafts], 1)
            pos = st["positions"][:, None] + steps
            logits, _ = prefill_chunk(model, cache, x, pos, ap, ctx, mesh)
            tgt, match = _spec_targets(logits, drafts, ctx, mesh, ap.cfg,
                                       st["rng"], st["sample_idx"],
                                       temperature, top_k)
            accepted = torch.cumprod(match.to(torch.int32), 1).sum(1)
            emitted = torch.where(steps[None] < accepted[:, None],
                                  torch.nn.functional.pad(drafts, (0, 1)),
                                  tgt)
            out[:, :C].copy_(emitted)
            out[:, C].copy_(accepted)
            out[:, C + 1].copy_(_finite_slots(logits, mesh))

    step = CapturedStep(body, cuda_graph and out.is_cuda,
                        workspace=getattr(mesh, "workspace", None))
    return step, drafts, out


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _item11(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: training covers the dense family at tp=1, alone or data-"
        "parallel over the pods of a VirtualMesh(pods, 1); the rest arrives "
        "with later parts of ROADMAP item 11")


def check_train_layout(ap: ArchPlan, ctx: ParallelCtx, mesh) -> int:
    """Raise unless (ap, ctx, mesh) is a layout the train step takes;
    returns R.  Without a mesh (one rank) every axis has size 1, so the
    reference's training ctx (``single_pod_ctx``: dp = fsdp = ("data",),
    TP, EP and SP over a size-1 "model" axis) is the local step.  On a
    ``VirtualMesh(pods, 1)`` the data-parallel axis is the slow one,
    ``ctx.dp == (slow,)``, with no TP and no FSDP over it.  TP > 1, FSDP
    over more than one rank and every family but ``dense`` raise
    ``NotImplementedError`` (ROADMAP item 11)."""
    cfg = ap.cfg
    if cfg.family != "dense":
        raise _item11(f"{cfg.name} ({cfg.family} family)")
    if ap.tp != 1:
        raise _item11(f"tp={ap.tp}")
    if mesh is None:
        return 1
    if mesh.fast > 1 or (mesh.pods > 1 and mesh.slow_axis in ctx.tp_axes):
        raise _item11(f"a TP group on {mesh}")
    if mesh.pods > 1 and mesh.slow_axis in ctx.fsdp:
        raise _item11(f"FSDP over {mesh.pods} ranks")
    if mesh.pods > 1 and tuple(ctx.dp) != (mesh.slow_axis,):
        raise ValueError(f"data parallelism over {mesh} needs ctx.dp = "
                         f"({mesh.slow_axis!r},), got {ctx.dp}")
    return mesh.size


def _per_rank(t, R: int, device) -> torch.Tensor:
    """A global batch array (B, ...) as R ranks' contiguous shares
    (R, B / R, ...), as the reference's ``data_specs`` cut it over dp."""
    t = torch.as_tensor(t, device=device).long()
    if t.shape[0] % R:
        raise ValueError(f"global batch {t.shape[0]} is not divisible by "
                         f"{R} data-parallel ranks")
    return t.reshape(R, t.shape[0] // R, *t.shape[1:])


def train_state(model: DenseLM, opt: Dict) -> Dict:
    """The checkpoint's tree: {"params", "opt": {"m", "v", "step"}}, each
    the global, unranked arrays (rank 0's copy) with the blocks on a
    leading layer axis, under the reference's keys."""
    def rank0(tree):
        return stack_layers(tree_map(lambda t: t.detach()[0], tree))

    return {"params": stack_layers(to_global(model)),
            "opt": {"m": rank0(opt["m"]), "v": rank0(opt["v"]),
                    "step": opt["step"]}}


@torch.no_grad()
def load_train_state(model: DenseLM, opt: Dict, state: Dict) -> None:
    """Write a :func:`train_state` tree (from any mesh) into ``model`` and
    ``opt`` in place, every rank a copy."""
    def put(dst, src):
        dst.copy_(src.to(dst.dtype).expand_as(dst))

    tree_map(put, params_tree(model), unstack_layers(state["params"]))
    for k in ("m", "v"):
        tree_map(put, opt[k], unstack_layers(state["opt"][k]))
    opt["step"].copy_(state["opt"]["step"])


class TrainStep:
    """The train step of :func:`build_train_step`: ``step(model, opt,
    batch) -> (model, opt, metrics)``, updating ``model`` and ``opt`` in
    place; :meth:`grads` and :meth:`update` are its two halves."""

    def __init__(self, ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                 microbatches: int, remat: bool, base_lr: float,
                 warmup: int, total_steps: int, clip_norm: float):
        self.R = check_train_layout(ap, ctx, mesh)
        self.ap, self.ctx, self.mesh = ap, ctx, mesh
        self.microbatches, self.remat = microbatches, remat
        self.base_lr, self.warmup, self.total_steps = base_lr, warmup, \
            total_steps
        self.clip_norm = clip_norm

    def grads(self, model: DenseLM, batch) -> Tuple[torch.Tensor, Dict]:
        """(loss, grads): the loss (R,) averaged over microbatches and
        over the batch ranks (``dp_psum_mean``), and every rank's f32
        gradient of its own batch's mean loss, accumulated over the
        microbatches and divided by their count (before the cross-pod
        sum), in the reference's layout behind the rank axis: each blocks
        leaf (R, L, ...) (``unstack_layers(grads, dim=1)`` gives the
        per-layer views), so the cross-pod sum takes the reference's
        leaves (rd_int8 its quantization groups)."""
        R, mb = self.R, self.microbatches
        if model.n_ranks != R:
            raise ValueError(f"a model of {model.n_ranks} ranks on a layout "
                             f"of {R}")
        params = params_tree(trainable(model))
        paths, leaves = zip(*tree_items(params))
        dev = leaves[0].device
        n_layers = len(params["blocks"])

        def zeros(t, lead=()):
            return torch.zeros(t.shape[:1] + lead + t.shape[1:],
                               dtype=torch.float32, device=dev)

        acc = {k: tree_map(lambda t: zeros(t, (n_layers,)), v[0])
               if k == "blocks" else tree_map(zeros, v)
               for k, v in params.items()}
        views = dict(tree_items(unstack_layers(acc, dim=1)))
        tok, lab = (_per_rank(batch[k], R, dev)
                    for k in ("tokens", "labels"))
        if tok.shape[1] % mb:
            raise ValueError(f"local batch {tok.shape[1]} is not divisible "
                             f"by microbatches={mb}")
        tok = tok.reshape(R, mb, -1, tok.shape[-1])
        lab = lab.reshape(R, mb, -1, lab.shape[-1])
        losses = []
        with torch.enable_grad():
            for i in range(mb):
                logits, _ = forward_lm(model, tok[:, i], self.ap, LOCAL,
                                       None, sp=False, remat=self.remat)
                loss = L.sharded_xent(logits, lab[:, i], LOCAL, None,
                                      self.ap.cfg.vocab_size)
                del logits
                g = torch.autograd.grad(loss.sum(), leaves)
                losses.append(hier.dp_psum_mean(loss.detach(), self.ctx,
                                                self.mesh))
                for path, t in zip(paths, g):
                    views[path].add_(t)
                del g
        for a in tree_leaves(acc):
            a.div_(mb)
        return torch.stack(losses).mean(0), acc

    def update(self, params: Dict, opt: Dict, grads: Dict
               ) -> Dict[str, torch.Tensor]:
        """The step's second half on a gradient tree from :meth:`grads`
        (the reference's layout behind the rank axis), in place on
        ``grads``, ``params`` and ``opt``: the cross-pod sum (a sum, not a
        mean: the reference's), the norm over every logical element once,
        the NaN / Inf guard, the clip and AdamW, all on the device.
        Returns the metrics but the loss."""
        hier.grad_cross_pod_reduce(grads, self.ctx, self.mesh)
        gnorm = global_grad_norm(grads, repl_factors(grads, self.R))
        grads = unstack_layers(grads, dim=1)
        skip = ~torch.isfinite(gnorm)
        clip = torch.full((), self.clip_norm, device=gnorm.device)
        scale = torch.where(gnorm > clip, clip / (gnorm + 1e-9),
                            torch.ones((), device=gnorm.device))
        lr = cosine_lr(opt["step"], base_lr=self.base_lr,
                       warmup=self.warmup, total=self.total_steps)
        adamw_update(grads, opt, params, lr=lr, grad_scale=scale, skip=skip)
        return {"grad_norm": gnorm, "skipped": skip.float(), "lr": lr}

    def __call__(self, model: DenseLM, opt: Dict, batch
                 ) -> Tuple[DenseLM, Dict, Dict[str, torch.Tensor]]:
        loss, grads = self.grads(model, batch)
        metrics = self.update(params_tree(model), opt, grads)
        return model, opt, {"loss": loss[0], **metrics}


def build_train_step(ap: ArchPlan, ctx: ParallelCtx, mesh, *,
                     microbatches: int = 1, remat: bool = True,
                     base_lr: float = 3e-4, warmup: int = 100,
                     total_steps: int = 10000, clip_norm: float = 1.0
                     ) -> TrainStep:
    """The reference's ``build_train_step`` for the layouts
    :func:`check_train_layout` takes: each rank's batch share (the global
    batch cut over the ranks, then into ``microbatches`` along the batch
    axis) through ``forward_lm`` (``remat``: each block recomputed in the
    backward pass; kernel 3 under autograd in every attention layer) and
    ``layers.sharded_xent``; the gradients accumulated in f32 and divided
    by ``microbatches``; summed over the pods by
    ``hierarchical.grad_cross_pod_reduce`` (``ctx.grad_reduce_strategy``);
    the global norm, ``skip = ~isfinite(norm)``, the clip scale,
    ``cosine_lr`` at ``opt["step"]`` and ``adamw_update`` in place.
    ``metrics`` holds ``loss`` (rank 0's: the batch ranks' mean),
    ``grad_norm``, ``skipped`` and ``lr`` as device scalars; nothing in
    the step syncs with the host.  ``opt`` is ``adamw_init(params_tree(
    model))``."""
    return TrainStep(ap, ctx, mesh, microbatches=microbatches, remat=remat,
                     base_lr=base_lr, warmup=warmup, total_steps=total_steps,
                     clip_norm=clip_norm)


__all__ = ["CapturedStep", "build_cache_init", "build_prefill",
           "build_decode_step", "build_serve_step", "build_admit_step",
           "build_admit_chunk_step", "build_spec_verify_step",
           "build_prefill_only_step", "build_kv_splice_step",
           "build_train_step", "check_train_layout", "TrainStep",
           "train_state", "load_train_state"]
