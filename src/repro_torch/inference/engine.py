"""YALIS-style batched inference engine (the paper's research vehicle), in
PyTorch: the port of the local, non-speculative path of
``repro/inference/engine.py``.

``generate`` runs the paper's *batched inference* workload: one batch of
prompts runs to completion (prefill + N decode steps) before the next
batch starts.  The paged cache (``block_size > 0``) uses the identity
block table, as the JAX engine's local path does.

Two modes, as in the reference: local (tp=1, no mesh) and mesh (tensor
parallel over a :class:`~repro_torch.core.mesh.VirtualMesh` on one card,
through the step builders of :mod:`repro_torch.parallel.steps`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.pcontext import LOCAL, ParallelCtx
from ..models import layers as L
from ..models.transformer import (ArchPlan, DenseLM, check_layout,
                                  decode_step, forward_lm, init_cache,
                                  seed_cache)
from ..parallel.steps import ARTable, build_decode_step, build_prefill


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the card.  A missing card is an error, never a quiet
    move to the CPU: the CPU runs only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path")
    return dev


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, prompt+new)
    new_tokens: np.ndarray       # (B, new)
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.new_tokens.size
        return n / self.decode_s if self.decode_s > 0 else float("inf")


class InferenceEngine:
    """Batched generation over a fixed model on one device."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *,
                 ctx: ParallelCtx = LOCAL, mesh=None, s_max: int = 4096,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 block_size: int = 0, ar_table: ARTable = None,
                 device: Optional[str | torch.device] = None):
        """``block_size > 0`` selects the paged KV layout (identity block
        table).  ``temperature > 0`` samples (optionally top-k) from a
        ``torch.Generator`` seeded with ``seed``.  ``device=None`` runs on
        the card and raises if there is none; the model is moved there.

        With a ``mesh`` (and the ctx that wires it) the engine runs the
        tensor-parallel path: dense cache only, as the reference's engine
        (a paged cache raises), and greedy sampling over the vocab shards,
        as the reference's mesh steps; ``temperature > 0`` raises rather
        than quietly going greedy.  ``ar_table`` (a persisted autotune
        table's path, or an ``AutoTuner``) is what the mesh steps resolve
        ``ar_strategy="auto"`` against (default: ``REPRO_AR_TABLE``, else
        the analytic tuner); ``ctx.overlap_matmul`` overlaps the
        row-parallel projections with their all-reduces."""
        self.ap = ap
        self.cfg = ap.cfg
        self.ctx = ctx
        self.mesh = mesh
        check_layout(ap, ctx, mesh)
        if mesh is not None:
            if block_size:
                raise NotImplementedError(
                    "the paged engine cache is local-path only; mesh-path "
                    "paged serving arrives with ROADMAP item 6")
            if temperature > 0:
                raise ValueError(
                    "the mesh path samples greedily over the vocab shards "
                    "(greedy_sample); temperature > 0 needs tp=1")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, engine on "
                             f"{self.device}")
        self.model = model.to(self.device)
        self.s_max = s_max
        self.temperature = temperature
        self.top_k = top_k
        self.block_size = block_size
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        if mesh is not None:
            self._mesh_prefill = build_prefill(ap, ctx, mesh, s_max=s_max,
                                               ar_table=ar_table)
            self._mesh_decode = build_decode_step(ap, ctx, mesh,
                                                  ar_table=ar_table)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor):
        if self.mesh is not None:
            return self._mesh_prefill(self.model, tokens)
        B = tokens.shape[0]
        logits, states = forward_lm(self.model, tokens, self.ap,
                                    collect_state=True)
        cache = init_cache(self.ap, B, self.s_max,
                           block_size=self.block_size, device=self.device)
        seed_cache(cache, states)
        nxt = torch.argmax(logits[:, -1, :self.cfg.vocab_size].float(),
                           dim=-1).to(torch.int32)
        return nxt, cache

    @torch.inference_mode()
    def _decode(self, cache, tokens: torch.Tensor, positions: torch.Tensor):
        if self.mesh is not None:
            return self._mesh_decode(self.model, cache, tokens, positions)[0]
        logits, cache = decode_step(self.model, cache, tokens, positions,
                                    self.ap)
        return L.sample_token(logits, self._gen,
                              temperature=self.temperature, top_k=self.top_k,
                              vocab_real=self.cfg.vocab_size)

    def generate(self, prompts: np.ndarray,
                 max_new_tokens: int) -> GenerationResult:
        """prompts: (B, S) int (uniform length).  Greedy unless the engine
        was built with ``temperature > 0`` (tp=1)."""
        prompts = np.asarray(prompts, np.int64)
        B, S = prompts.shape
        if S + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceed s_max={self.s_max}")
        tokens = torch.as_tensor(prompts, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        cur, cache = self._prefill(tokens)
        self._sync()
        t1 = time.perf_counter()
        out = [cur]
        positions = torch.full((B,), S, dtype=torch.int32, device=self.device)
        for _ in range(max_new_tokens - 1):
            cur = self._decode(cache, cur, positions)
            positions = positions + 1
            out.append(cur)
        new = torch.stack(out, dim=1).cpu().numpy()   # waits for the device
        t2 = time.perf_counter()
        return GenerationResult(
            tokens=np.concatenate([prompts.astype(np.int32), new], axis=1),
            new_tokens=new, prefill_s=t1 - t0, decode_s=t2 - t1,
            steps=max_new_tokens)


__all__ = ["InferenceEngine", "GenerationResult", "resolve_device"]
