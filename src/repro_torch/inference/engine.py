"""YALIS-style batched inference engine (the paper's research vehicle), in
PyTorch: the port of the local, non-speculative path of
``repro/inference/engine.py``.

``generate`` runs the paper's *batched inference* workload: one batch of
prompts runs to completion (prefill + N decode steps) before the next
batch starts.  The paged cache (``block_size > 0``) uses the identity
block table, as the JAX engine's local path does.

Two modes, as in the reference: local (tp=1, no mesh) and mesh (tensor
parallel over a :class:`~repro_torch.core.mesh.VirtualMesh` on one card),
both through the step builders of :mod:`repro_torch.parallel.steps`.  On
the card the decode loop is a CUDA graph: the first step of a batch size
runs eagerly, the second is captured and every later one (in this and
later ``generate`` calls at that batch size) replays it, over a cache and
static token, position and output tensors the engine keeps for that batch
size (``cuda_graph=False`` keeps every step eager); a prefill that grows
an exchange buffer the graph took (a longer prompt under overlap) has
the step captured anew (``parallel.steps.CapturedStep``).  On the CPU the
loop is eager.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.pcontext import LOCAL, ParallelCtx
from ..models import layers as L
from ..models.transformer import ArchPlan, DenseLM, check_layout
from ..parallel.steps import (ARTable, CapturedStep, build_cache_init,
                              build_decode_step, build_prefill)


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
    graph_replays: int = 0       # decode steps replayed from a CUDA graph
    graph_recaptures: int = 0    # captures anew after a buffer moved

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.new_tokens.size
        return n / self.decode_s if self.decode_s > 0 else float("inf")


@dataclasses.dataclass
class _DecodeLoop:
    """The decode loop of one batch size: its cache and the static tensors
    a captured step reads and writes in place (the current tokens, their
    positions, each row's chain key and token index, and the output, token
    t of row b at [b, t])."""
    cache: dict
    cur: torch.Tensor
    positions: torch.Tensor
    keys: torch.Tensor
    idx: torch.Tensor
    out: torch.Tensor
    step: Optional[CapturedStep] = None


class InferenceEngine:
    """Batched generation over a fixed model on one device."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *,
                 ctx: ParallelCtx = LOCAL, mesh=None, s_max: int = 4096,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 block_size: int = 0, ar_table: ARTable = None,
                 device: Optional[str | torch.device] = None,
                 cuda_graph: bool = True):
        """``block_size > 0`` selects the paged KV layout (identity block
        table; on a mesh each rank's pool is folded into one, as
        ``transformer.init_cache`` lays it out).  ``temperature > 0``
        samples (optionally top-k), row b from its own stateless chain
        ``layers.sampling_key(seed, b)``, token t at index t, the prefill's
        first token included; on a mesh the vocab shards are gathered
        first.  ``device=None`` runs on the card and raises if there is
        none; the model is moved there.

        With a ``mesh`` (and the ctx that wires it) the engine runs the
        tensor-parallel path.  ``ar_table`` (a persisted autotune table's
        path, or an ``AutoTuner``) is what the steps resolve
        ``ar_strategy="auto"`` against (default: ``REPRO_AR_TABLE``, else
        the analytic tuner); ``ctx.overlap_matmul`` overlaps the
        row-parallel projections with their all-reduces.  ``cuda_graph``
        (on a CUDA device) replays the decode step from a CUDA graph;
        False runs every step eagerly, as the CPU does (the attribute may
        be switched between ``generate`` calls)."""
        self.ap = ap
        self.cfg = ap.cfg
        self.ctx = ctx
        self.mesh = mesh
        check_layout(ap, ctx, mesh)
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, engine on "
                             f"{self.device}")
        self.model = model.to(self.device)
        self.s_max = s_max
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.block_size = block_size
        self._cuda = self.device.type == "cuda"
        self.cuda_graph = cuda_graph
        kw = dict(temperature=temperature, top_k=top_k, ar_table=ar_table)
        self._prefill = build_prefill(ap, ctx, mesh, s_max=s_max,
                                      block_size=block_size, **kw)
        self._decode = build_decode_step(ap, ctx, mesh, **kw)
        self._loop: Optional[_DecodeLoop] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_loop(self, B: int) -> _DecodeLoop:
        """The loop of batch size B, made at its first use (a new B, or
        ``cuda_graph`` switched since, replaces the last one's: one cache
        is held at a time)."""
        lp = self._loop
        if lp is not None and lp.cur.shape[0] == B \
                and lp.step.graph == (self.cuda_graph and self._cuda):
            return lp
        self._loop = None
        dev = self.device
        keys = torch.tensor([L.sampling_key(self.seed, b) for b in range(B)],
                            dtype=torch.int64, device=dev)
        lp = _DecodeLoop(
            cache=build_cache_init(self.ap, self.ctx, self.mesh, slots=B,
                                   s_max=self.s_max,
                                   block_size=self.block_size,
                                   device=dev)(),
            cur=torch.zeros(B, dtype=torch.int32, device=dev),
            positions=torch.zeros(B, dtype=torch.int32, device=dev),
            keys=keys, idx=torch.zeros(B, dtype=torch.int32, device=dev),
            out=torch.zeros((B, self.s_max), dtype=torch.int32, device=dev))

        @torch.inference_mode()
        def body():
            nxt, _ = self._decode(self.model, lp.cache, lp.cur, lp.positions,
                                  lp.keys, lp.idx)
            lp.out.scatter_(1, lp.idx[:, None].long(), nxt[:, None])
            lp.cur.copy_(nxt)
            lp.positions.add_(1)
            lp.idx.add_(1)

        lp.step = CapturedStep(body, self.cuda_graph and self._cuda,
                               workspace=getattr(self.mesh, "workspace",
                                                 None))
        self._loop = lp
        return lp

    def generate(self, prompts: np.ndarray,
                 max_new_tokens: int) -> GenerationResult:
        """prompts: (B, S) int (uniform length).  Greedy unless the engine
        was built with ``temperature > 0``."""
        prompts = np.asarray(prompts, np.int64)
        B, S = prompts.shape
        if S + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceed s_max={self.s_max}")
        tokens = torch.as_tensor(prompts, device=self.device)
        lp = self._decode_loop(B)
        self._sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            nxt, _ = self._prefill(self.model, tokens, lp.keys,
                                   cache=lp.cache)
            lp.cur.copy_(nxt)
            lp.out[:, 0] = nxt
        lp.positions.fill_(S)
        lp.idx.fill_(1)
        self._sync()
        t1 = time.perf_counter()
        replays, recaptures = lp.step.replays, lp.step.recaptures
        for _ in range(max_new_tokens - 1):
            lp.step()
        new = lp.out[:, :max_new_tokens].cpu().numpy()  # waits for the device
        t2 = time.perf_counter()
        return GenerationResult(
            tokens=np.concatenate([prompts.astype(np.int32), new], axis=1),
            new_tokens=new, prefill_s=t1 - t0, decode_s=t2 - t1,
            steps=max_new_tokens, graph_replays=lp.step.replays - replays,
            graph_recaptures=lp.step.recaptures - recaptures)


__all__ = ["InferenceEngine", "GenerationResult", "resolve_device"]
