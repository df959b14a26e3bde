"""YALIS-style batched inference engine (the paper's research vehicle), in
PyTorch: the port of ``repro/inference/engine.py``, speculative
``generate`` included (dense family).

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
loop is eager.  With ``spec_mode`` each step instead verifies ``spec_k``
drafted tokens of every row in one pass (``build_spec_verify_step``, kept
and captured beside the decode loop), each row advancing by its own
accepted length; greedy output equals plain greedy ``generate``.
``generate(..., extra=)`` carries an encoder-decoder's frame embeddings
and a VLM's patch embeddings into the prefill, as in the reference; the
prefill seeds the cross K/V into the loop's cache in place, so the
captured decode step serves every batch.
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
                              build_decode_step, build_prefill,
                              build_spec_verify_step)
from .speculative import make_drafter


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
    spec: Optional[tuple] = None     # the verify step: (step, drafts, out)


class InferenceEngine:
    """Batched generation over a fixed model on one device."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *,
                 ctx: ParallelCtx = LOCAL, mesh=None, s_max: int = 4096,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 block_size: int = 0, ar_table: ARTable = None,
                 spec_mode: Optional[str] = None, spec_k: int = 4,
                 draft_arch: str = "llama3.2-1b", drafter=None,
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
        be switched between ``generate`` calls).

        ``spec_mode`` ("ngram", "draft" with ``draft_arch``, "replay", or
        an injected ``drafter``) makes ``generate`` speculative: each step
        verifies ``spec_k`` drafted tokens of every row in one pass.
        Dense family only."""
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
        self._kw = kw
        self._loop: Optional[_DecodeLoop] = None
        if drafter is not None and not spec_mode:
            raise ValueError("an injected drafter needs spec_mode set")
        if spec_mode and self.cfg.family != "dense":
            raise ValueError("speculative generate supports dense families "
                             f"only, not {self.cfg.family!r}")
        self.spec_mode = spec_mode
        self.spec_k = spec_k
        self._draft_arch = draft_arch
        self._drafter = drafter

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

    def _extra(self, extra: Optional[dict], B: int) -> dict:
        """``extra``'s frames / patches as tensors on the engine's device,
        their shapes checked: ``frame_embeds`` (B, enc_seq, D), required by
        an encoder-decoder; ``patch_embeds`` (B, n_patches, D), a VLM's
        (without them it generates from text alone, as the reference's
        local engine does)."""
        cfg, extra = self.cfg, dict(extra or {})
        want = {"frame_embeds": (B, cfg.enc_seq, cfg.d_model),
                "patch_embeds": (B, cfg.n_patches, cfg.d_model)}
        family = {"frame_embeds": "encdec", "patch_embeds": "vlm"}
        out = {}
        for name, a in extra.items():
            if name not in want or cfg.family != family[name]:
                raise ValueError(f"{cfg.name} ({cfg.family}) takes no "
                                 f"{name!r}")
            t = torch.as_tensor(np.asarray(a, np.float32)
                                if isinstance(a, np.ndarray) else a)
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} of shape {tuple(t.shape)}, "
                                 f"expected {want[name]}")
            out[name] = t.to(self.device, cfg.dtype)
        if cfg.family == "encdec" and "frame_embeds" not in out:
            raise ValueError(f"{cfg.name}: generate needs "
                             "extra['frame_embeds']")
        return out

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 extra: Optional[dict] = None) -> GenerationResult:
        """prompts: (B, S) int (uniform length).  Greedy unless the engine
        was built with ``temperature > 0``.  ``extra``: {"frame_embeds"
        (B, enc_seq, D)} for an encoder-decoder, {"patch_embeds" (B,
        n_patches, D)} for a VLM, numpy arrays or tensors (moved to the
        engine's device in the model's dtype)."""
        prompts = np.asarray(prompts, np.int64)
        B, S = prompts.shape
        if S + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceed s_max={self.s_max}")
        extra = self._extra(extra, B)
        tokens = torch.as_tensor(prompts, device=self.device)
        lp = self._decode_loop(B)
        if self.spec_mode:
            return self._generate_spec(lp, prompts, tokens, max_new_tokens)
        self._sync()
        t0 = time.perf_counter()
        self._prefill_into(lp, tokens, extra)
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


    def _prefill_into(self, lp: _DecodeLoop, tokens: torch.Tensor,
                      extra: Optional[dict] = None) -> None:
        """The batch's prefill into the loop's cache; its first tokens in
        ``lp.cur`` and ``lp.out[:, 0]``, positions and indices set."""
        with torch.inference_mode():
            nxt, _ = self._prefill(self.model, tokens, lp.keys,
                                   cache=lp.cache, **(extra or {}))
            lp.cur.copy_(nxt)
            lp.out[:, 0] = nxt
        lp.positions.fill_(tokens.shape[1])
        lp.idx.fill_(1)

    def _generate_spec(self, lp: _DecodeLoop, prompts: np.ndarray,
                       tokens: torch.Tensor,
                       max_new_tokens: int) -> GenerationResult:
        """Speculative batched generation (the reference's
        ``_generate_spec``): every row shares each verify pass but advances
        by its own accepted length; rows that reach ``max_new_tokens`` go
        inactive and verify into their own rows harmlessly until the batch
        drains.  ``steps`` counts the prefill and the verify passes."""
        B, S = prompts.shape
        k = self.spec_k
        if lp.spec is None:
            lp.spec = build_spec_verify_step(
                self.ap, self.ctx, self.mesh, model=self.model,
                cache=lp.cache, state={"tokens": lp.cur,
                                       "positions": lp.positions,
                                       "rng": lp.keys, "sample_idx": lp.idx},
                k=k, cuda_graph=self.cuda_graph and self._cuda, **self._kw)
        step, drafts_dev, out = lp.spec
        if self._drafter is None:
            self._drafter = make_drafter(self.spec_mode,
                                         draft_arch=self._draft_arch,
                                         seed=self.seed, device=self.device)
        drafter = self._drafter
        self._sync()
        t0 = time.perf_counter()
        self._prefill_into(lp, tokens)
        cur = lp.cur.cpu().numpy().copy()
        t1 = time.perf_counter()
        outputs = [[int(t)] for t in cur]
        for b in range(B):
            drafter.reset(b, list(prompts[b]) + [int(cur[b])])
        positions = np.full((B,), S, np.int32)
        idx = np.ones((B,), np.int32)
        remaining = np.full((B,), max_new_tokens - 1, np.int32)
        active = remaining > 0
        replays, recaptures = step.replays, step.recaptures
        steps = 1
        while active.any():
            drafts = np.zeros((B, k), np.int32)
            for b in range(B):
                if active[b]:
                    drafts[b] = np.clip(drafter.draft(b, k), 0,
                                        self.cfg.vocab_size - 1)
            for dev_t, host in ((lp.cur, cur), (lp.positions, positions),
                                (lp.idx, idx), (drafts_dev, drafts)):
                dev_t.copy_(torch.from_numpy(host))
            step()
            res = out.cpu().numpy()
            if not res[active, k + 2].all():
                raise RuntimeError("non-finite verify logits in a batched "
                                   "generate")
            steps += 1
            for b in np.flatnonzero(active):
                take = min(int(res[b, k + 1]) + 1, int(remaining[b]),
                           self.s_max - 1 - int(positions[b]))
                toks = [int(t) for t in res[b, :take]]
                outputs[b].extend(toks)
                drafter.observe(b, toks)
                cur[b] = toks[-1]
                positions[b] += take
                idx[b] += take
                remaining[b] -= take
                if remaining[b] <= 0 or positions[b] >= self.s_max - 1:
                    active[b] = False
        t2 = time.perf_counter()
        new = np.asarray([o[:max_new_tokens] for o in outputs], np.int32)
        return GenerationResult(
            tokens=np.concatenate([prompts.astype(np.int32), new], axis=1),
            new_tokens=new, prefill_s=t1 - t0, decode_s=t2 - t1,
            steps=steps, graph_replays=step.replays - replays,
            graph_recaptures=step.recaptures - recaptures)


__all__ = ["InferenceEngine", "GenerationResult", "resolve_device"]
