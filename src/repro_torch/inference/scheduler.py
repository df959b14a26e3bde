"""Continuous batching over the serve step (Orca-style), and trace replay:
the port of ``repro/inference/scheduler.py``'s :class:`ContinuousBatcher`
with full-prefill admission, :class:`Request`, :class:`ServeMetrics` and
:func:`make_trace`.

The batcher owns a fixed pool of batch slots.  Each engine step decodes
every slot; slots freed by finished requests are refilled from the
waiting queue.  Positions are per slot, so one fixed-shape step serves
ragged batches, the mechanism of the paper's trace evaluation
(Sec. 5.2.3).

* The step (decode, sampling, token / position / remaining update) is
  ``parallel.steps.build_serve_step``: at tp=1 without a mesh, or over a
  :class:`~repro_torch.core.mesh.VirtualMesh` with ``ar_table`` and
  ``ctx.overlap_matmul``.  On the card it is a CUDA graph, captured at the
  second step and replayed after (captured anew if an admission's prefill
  has grown an exchange buffer it took); its state, the cache and the
  block table are tensors it was built over, which the batcher updates in
  place.  The host reads back one (3, slots) tensor a step: emitted
  tokens, done flags, finite flags.
* Admission is a full prefill of the prompt spliced into the slot's row
  (``build_admit_step``), eager, as the reference compiles one executable
  a prompt length; it serves every family.
* With ``block_size > 0`` the K/V are paged: a host-side
  :class:`~repro_torch.inference.kv_cache.BlockAllocator` grows each
  slot's block list on demand and preempts (evicts and requeues) the
  youngest request when the pool runs dry; a preempted request is
  recomputed from scratch with its own sampling chain, so its tokens are
  those of an undisturbed run.  On a mesh every rank has its own pool of
  ``n_blocks``, read through one folded table (``transformer.fold_table``).

Scheduling time is a logical step clock (1.0 an engine step), so traces
replay deterministically; wall-clock times are recorded beside it for TTFT
and TPOT.  Left to later slices, each refused with its ROADMAP item:
chunked admission (item 6b), speculative decoding, the prefix cache,
fault injection and deadlines (item 7), handoff admission (item 8) and
the int8 KV cache (item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.pcontext import LOCAL, ParallelCtx
from ..models import layers as L
from ..models.transformer import ArchPlan, DenseLM, fold_table
from ..parallel.steps import (ARTable, build_admit_step, build_cache_init,
                              build_serve_step)
from .engine import resolve_device
from .kv_cache import BlockAllocator, paged_geometry


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,)
    max_new: int
    arrival_s: float = 0.0       # logical (step-clock) arrival
    # filled by the scheduler:
    first_token_s: float = -1.0  # wall-clock, relative to run() start
    done_s: float = -1.0         # wall-clock, relative to run() start
    admit_step: int = -1         # logical step of (last) admission
    done_step: int = -1
    preempted: int = 0           # times evicted and recomputed
    output: Optional[np.ndarray] = None


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else float("nan")


def request_sampling_key(seed: int, rid: int) -> Tuple[int, int]:
    """Base key of request ``rid``'s sampling chain: token t of the request
    is drawn at index t of it, a stateless chain keyed on the request, not
    on the step schedule, so a preempted request's recompute resamples its
    original tokens.  Temperature 0 never reads it."""
    return L.sampling_key(seed, rid)


@dataclasses.dataclass
class ServeMetrics:
    """Trace-replay metrics.  TTFT (time to first token) and TPOT (time per
    output token) are counted in logical steps (admission wait plus the
    prefill's step for TTFT) and converted to seconds by the measured mean
    step time; ``throughput_tok_s`` is new tokens over the run's wall
    time.  ``wasted_tokens`` counts tokens decoded and then discarded by a
    preemption."""
    requests: int
    completed: int
    total_new_tokens: int
    steps: int
    wall_s: float
    throughput_tok_s: float
    ttft_steps_p50: float
    ttft_steps_p99: float
    tpot_steps_p50: float
    tpot_steps_p99: float
    ttft_s_p50: float
    ttft_s_p99: float
    tpot_s_p50: float
    tpot_s_p99: float
    preemptions: int
    peak_kv_tokens: int          # high-water cache footprint, in tokens
    kv_capacity_tokens: int      # reserved footprint of the layout
    cache_utilization: float     # occupied / reserved at peak usage
    cache_stats: Optional[Dict[str, Any]] = None
    wasted_tokens: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class ContinuousBatcher:
    """Slot-based continuous batching on the local or mesh path."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *, slots: int = 8,
                 s_max: int = 512, ctx: ParallelCtx = LOCAL, mesh=None,
                 block_size: int = 0, n_blocks: Optional[int] = None,
                 kv_quant: bool = False, ar_table: ARTable = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 admit_mode: str = "full", spec_mode: Optional[str] = None,
                 prefix_cache: str = "off", injector=None,
                 deadline_s: Optional[float] = None,
                 device: Optional[str | torch.device] = None,
                 cuda_graph: bool = True):
        """``block_size > 0`` pages the K/V (a pool of ``n_blocks`` a rank,
        by default every slot at full length plus the trash block);
        ``temperature > 0`` samples from each request's chain under
        ``seed``; ``device=None`` runs on the card and raises if there is
        none.  ``cuda_graph=False`` keeps the card's serve step eager."""
        if admit_mode == "chunked":
            raise NotImplementedError(
                "chunked admission arrives with ROADMAP item 6b (kernel 3 "
                "needs a query offset); use admit_mode='full'")
        if admit_mode != "full":
            raise ValueError(f"unknown admit_mode {admit_mode!r}")
        if spec_mode:
            raise NotImplementedError(
                "speculative decoding arrives with ROADMAP item 7")
        if prefix_cache != "off":
            raise NotImplementedError(
                "the prefix cache arrives with ROADMAP item 7")
        if injector is not None or deadline_s is not None:
            raise NotImplementedError(
                "fault injection and deadlines arrive with ROADMAP item 7")
        if kv_quant:
            raise NotImplementedError(
                "the int8 KV cache arrives with ROADMAP item 9")
        self.ap, self.cfg = ap, ap.cfg
        self.slots = slots
        self.s_max = s_max
        self.ctx = ctx
        self.mesh = mesh
        self.temperature = temperature
        self.seed = seed
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, batcher on "
                             f"{self.device}")
        self.model = model.to(self.device)
        self.R = mesh.size if mesh is not None else 1
        # paging applies to the self-attention K/V only; the ssm family's
        # recurrent state stays one row a slot
        self.paged = block_size > 0 and not self.cfg.attn_free
        self.block_size = block_size if self.paged else 0
        self.alloc: Optional[BlockAllocator] = None
        if self.paged:
            max_blocks = paged_geometry(s_max, block_size)
            if n_blocks is None:
                n_blocks = slots * max_blocks + 1
            self.alloc = BlockAllocator(n_blocks, block_size, slots,
                                        max_blocks)
        self.n_blocks = n_blocks
        self.cache = build_cache_init(
            ap, ctx, mesh, slots=slots, s_max=s_max,
            block_size=self.block_size, n_blocks=n_blocks,
            device=self.device)()
        # host mirrors of the device-side slot state
        self.positions = np.zeros((slots,), np.int32)
        self.remaining = np.zeros((slots,), np.int32)
        self.tokens = np.zeros((slots,), np.int32)
        self.active_mask = np.zeros((slots,), bool)
        # slot s's next token draws index sample_idx[s] of chain slot_key[s]
        self.slot_key = np.zeros((slots, 2), np.int64)
        self.sample_idx = np.zeros((slots,), np.int32)
        dev = self.device
        self._state = {
            "tokens": torch.zeros(slots, dtype=torch.int32, device=dev),
            "positions": torch.zeros(slots, dtype=torch.int32, device=dev),
            "remaining": torch.zeros(slots, dtype=torch.int32, device=dev),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
            "rng": torch.zeros((slots, 2), dtype=torch.int64, device=dev),
            "sample_idx": torch.zeros(slots, dtype=torch.int32,
                                      device=dev)}
        kw = dict(temperature=temperature, top_k=top_k, ar_table=ar_table)
        self._serve, self._serve_out = build_serve_step(
            ap, ctx, mesh, model=self.model, cache=self.cache,
            state=self._state, s_max=s_max, cuda_graph=cuda_graph, **kw)
        self._admit_step = build_admit_step(ap, ctx, mesh, **kw)
        self._table_version = -1
        if self.paged:
            self._sync_table()
        self._admit_seq = np.full((slots,), -1, np.int64)  # admission order
        self._seq = 0
        self.active: List[Optional[Request]] = [None] * slots
        self.outputs: Dict[int, List[int]] = {}
        self._dirty = True
        self.steps_run = 0
        self._wall0 = time.perf_counter()
        self._wall_run = 0.0     # wall seconds of the last run(), at drain
        self._peak_occupied = 0  # max sum of live positions, in tokens
        self._requeue: List[Request] = []   # preempted, awaiting admission
        self._preemptions = 0
        self._wasted_tokens = 0

    @property
    def graph_replays(self) -> int:
        """Serve steps replayed from the CUDA graph so far."""
        return self._serve.replays

    @property
    def graph_recaptures(self) -> int:
        """Times the serve step was captured anew after an admission grew
        an exchange buffer its graph held."""
        return self._serve.recaptures

    # -- state / device sync -------------------------------------------------

    def _push_state(self):
        host = {"tokens": self.tokens, "positions": self.positions,
                "remaining": self.remaining, "active": self.active_mask,
                "rng": self.slot_key, "sample_idx": self.sample_idx}
        for k, v in host.items():
            self._state[k].copy_(torch.from_numpy(v))
        self._dirty = False

    def _sync_table(self):
        """Copy the allocator's table, folded over the ranks, into the
        cache's (the tensor a captured step reads) when it has moved."""
        if self.alloc.version != self._table_version:
            tbl = torch.from_numpy(self.alloc.table)
            self.cache["block_tbl"].copy_(
                fold_table(tbl, self.R, self.n_blocks))
            self._table_version = self.alloc.version

    # -- admission -----------------------------------------------------------

    def _admit(self, slot: int, req: Request, now: float) -> bool:
        """Prefill one request into ``slot``.  Returns False when the paged
        pool cannot hold the prompt right now."""
        S = int(req.prompt.shape[0])
        if S + 1 > self.s_max:
            raise ValueError(f"prompt len {S} + 1 exceeds s_max={self.s_max}")
        if self.alloc is not None:
            # +1: the first decode write lands at position S
            if not self.alloc.ensure(slot, S + 1):
                return False
            self._sync_table()
        key = request_sampling_key(self.seed, req.rid)
        tok = self._admit_step(
            self.model, self.cache,
            torch.as_tensor(req.prompt[None], dtype=torch.int64,
                            device=self.device), slot,
            torch.tensor([key], dtype=torch.int64, device=self.device))
        self._activate(slot, req, int(tok[0]), S, now, key)
        return True

    def _activate(self, slot: int, req: Request, nxt: int, S: int,
                  now: float, key: Tuple[int, int]) -> None:
        """The slot holds ``req`` at position ``S`` with its first token
        ``nxt`` (token 0 of its chain) emitted."""
        self.slot_key[slot] = key
        self.sample_idx[slot] = 1
        self.active[slot] = req
        self.positions[slot] = S
        self.remaining[slot] = req.max_new - 1
        self.tokens[slot] = nxt
        self.active_mask[slot] = True
        self._admit_seq[slot] = self._seq
        self._seq += 1
        self.outputs[req.rid] = [nxt]
        req.admit_step = int(now)
        req.first_token_s = time.perf_counter() - self._wall0
        self._dirty = True
        if self.remaining[slot] == 0:   # max_new == 1: prefill token only
            self._release(slot, now)

    def _release(self, slot: int, now: float):
        req = self.active[slot]
        req.done_s = time.perf_counter() - self._wall0
        req.done_step = int(now)
        req.output = np.asarray(self.outputs[req.rid], np.int32)
        self.active[slot] = None
        self.active_mask[slot] = False
        self.remaining[slot] = 0
        self.sample_idx[slot] = 0
        self._admit_seq[slot] = -1
        if self.alloc is not None:
            self.alloc.free(slot)
            self._sync_table()
        self._dirty = True

    # -- preemption ----------------------------------------------------------

    def _evict(self, slot: int) -> None:
        """Evict ``slot``'s request and requeue it for recompute from
        scratch; the recompute replays the request's own sampling chain,
        so its tokens are those of an undisturbed run."""
        req = self.active[slot]
        req.preempted += 1
        self._preemptions += 1
        self._wasted_tokens += len(self.outputs[req.rid])
        del self.outputs[req.rid]
        self.active[slot] = None
        self.active_mask[slot] = False
        self.remaining[slot] = 0
        self._admit_seq[slot] = -1
        if self.alloc is not None:
            self.alloc.preempt(slot)
            self._sync_table()
        self._requeue.append(req)
        self._dirty = True

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted active request (last come,
        first preempted).  Returns False when nothing is evictable."""
        live = [s for s in range(self.slots) if self.active_mask[s]]
        if not live:
            return False
        self._evict(max(live, key=lambda s: self._admit_seq[s]))
        return True

    def _ensure_growth(self, slot: int) -> None:
        """Blocks cover the slot's next write position; on a dry pool,
        preempt youngest-first until the growth fits (the growing slot
        itself may be the victim)."""
        n_tokens = int(self.positions[slot]) + 1
        while not self.alloc.ensure(slot, n_tokens):
            victim_ok = self._preempt_youngest()
            if not self.active_mask[slot]:
                return  # we evicted ourselves
            if not victim_ok:
                raise RuntimeError(
                    "paged KV pool cannot hold a single request; "
                    "raise n_blocks")
        self._sync_table()

    # -- one engine step -----------------------------------------------------

    def step(self, now: float):
        """One decode step over all slots (no-op when none is active)."""
        if not self.active_mask.any():
            return
        if self.alloc is not None:
            for s in range(self.slots):
                # growth only at block boundaries: the next write position
                # is positions[s], covered unless it opens a fresh block
                if self.active_mask[s] \
                        and self.positions[s] % self.block_size == 0:
                    self._ensure_growth(s)
            if not self.active_mask.any():
                return
        occ = int(self.positions[self.active_mask].sum()) + \
            int(self.active_mask.sum())
        self._peak_occupied = max(self._peak_occupied, occ)
        if self._dirty:
            self._push_state()
        was_active = self.active_mask.copy()
        self._serve()
        emitted, done, finite = self._serve_out.cpu().numpy()
        self.steps_run += 1
        for s in range(self.slots):
            if not was_active[s]:
                continue
            if not finite[s]:
                raise RuntimeError(
                    f"slot {s}: non-finite logits (quarantine and recompute "
                    "arrive with ROADMAP item 7)")
            self.outputs[self.active[s].rid].append(int(emitted[s]))
            self.tokens[s] = emitted[s]
            self.positions[s] += 1
            self.remaining[s] -= 1
            self.sample_idx[s] += 1
            if self.alloc is not None:
                self.alloc.note_usage(s, int(self.positions[s]))
            if done[s]:
                self._release(s, now)

    # -- trace replay --------------------------------------------------------

    def reset_run_stats(self) -> None:
        """Reset per-run accounting so :meth:`metrics` reflects one trace;
        slot ownership is untouched."""
        self.steps_run = 0
        self._peak_occupied = 0
        self.outputs = {}
        self._wasted_tokens = 0
        self._preemptions = 0
        if self.alloc is not None:
            self.alloc.reset_stats()
        self._wall0 = time.perf_counter()

    def tick(self, arrived: List[Request], now: float) -> None:
        """One logical tick over a queue of due arrivals (mutated in place):
        admit (preempted requests first, then arrivals, FCFS), then run one
        engine step."""
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            if self._requeue:
                if self._admit(s, self._requeue[0], now):
                    self._requeue.pop(0)
                continue
            if arrived:
                if self._admit(s, arrived[0], now):
                    arrived.pop(0)
        self.step(now)

    def drained(self, arrived: List[Request]) -> bool:
        """No queued, requeued or active work left."""
        return not arrived and not self._requeue \
            and all(a is None for a in self.active)

    def run(self, requests: List[Request],
            max_steps: int = 100000) -> List[Request]:
        """Replay a trace to completion (requests admitted in arrival
        order on the step clock)."""
        waiting = sorted(requests, key=lambda r: r.arrival_s)
        qi = 0
        now = 0.0
        arrived: List[Request] = []
        if not self.active_mask.any() and not self._requeue:
            self.reset_run_stats()
        self._wall0 = time.perf_counter()
        for _ in range(max_steps):
            while qi < len(waiting) and waiting[qi].arrival_s <= now:
                arrived.append(waiting[qi])
                qi += 1
            if qi >= len(waiting) and self.drained(arrived):
                break
            self.tick(arrived, now)
            now += 1.0  # logical step clock
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._wall_run = time.perf_counter() - self._wall0
        return requests

    def defragment(self):
        """Compact the physical block pool (paged only): the allocator's
        permutation applied to every rank's pool in place, then the
        rewritten table copied in."""
        if self.alloc is None:
            return
        perm = self.alloc.defragment()
        if perm is None:
            return
        p = torch.as_tensor(perm, dtype=torch.int64, device=self.device)
        p = (p[None] + self.n_blocks * torch.arange(
            self.R, device=self.device)[:, None]).reshape(-1)
        for n in ("k", "v"):
            self.cache[n].copy_(self.cache[n][:, p])
        self._sync_table()

    # -- metrics -------------------------------------------------------------

    def metrics(self, requests: List[Request]) -> ServeMetrics:
        done = [r for r in requests if r.output is not None]
        wall = self._wall_run
        total_new = sum(len(r.output) for r in done)
        step_s = wall / self.steps_run if self.steps_run else 0.0
        # TTFT: queueing wait + the admission (prefill) tick
        ttft = [max(r.admit_step - r.arrival_s, 0.0) + 1.0 for r in done]
        # TPOT over decode tokens only: a request admitted at step t decodes
        # at steps t..done_step inclusive, done-admit+1 steps for len-1
        # tokens
        tpot = [(r.done_step - r.admit_step + 1) / (len(r.output) - 1)
                for r in done if len(r.output) > 1]
        if self.alloc is not None:
            st = self.alloc.stats()
            peak_tok = st.peak_used_blocks * st.block_size
            cap = (st.n_blocks - 1) * st.block_size
            util = self._peak_occupied / peak_tok if peak_tok else 0.0
            assert st.preemptions == self._preemptions, \
                (st.preemptions, self._preemptions)
            cache_stats = st.to_dict()
        else:
            peak_tok = cap = self.slots * self.s_max
            util = self._peak_occupied / cap if cap else 0.0
            cache_stats = None
        return ServeMetrics(
            requests=len(requests), completed=len(done),
            total_new_tokens=total_new, steps=self.steps_run, wall_s=wall,
            throughput_tok_s=total_new / wall if wall > 0 else 0.0,
            ttft_steps_p50=_percentile(ttft, 50),
            ttft_steps_p99=_percentile(ttft, 99),
            tpot_steps_p50=_percentile(tpot, 50),
            tpot_steps_p99=_percentile(tpot, 99),
            ttft_s_p50=_percentile(ttft, 50) * step_s,
            ttft_s_p99=_percentile(ttft, 99) * step_s,
            tpot_s_p50=_percentile(tpot, 50) * step_s,
            tpot_s_p99=_percentile(tpot, 99) * step_s,
            preemptions=self._preemptions, peak_kv_tokens=int(peak_tok),
            kv_capacity_tokens=int(cap), cache_utilization=float(util),
            cache_stats=cache_stats, wasted_tokens=self._wasted_tokens)


def make_trace(n_requests: int, *, mean_in: int, mean_out: int,
               rate: float, burstiness: float = 2.0, vocab: int = 97,
               seed: int = 0) -> List[Request]:
    """BurstGPT-style synthetic trace: gamma inter-arrivals (shape =
    1/CV^2 ~ burstiness), lognormal-ish lengths (paper Appendix C.4.2)."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / burstiness
    gaps = rng.gamma(shape, scale=1.0 / (rate * shape), size=n_requests)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n_requests):
        s_in = max(8, int(rng.lognormal(np.log(mean_in), 0.6)) // 8 * 8)
        s_out = max(1, int(rng.lognormal(np.log(mean_out), 0.6)))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, s_in).astype(np.int32),
            max_new=s_out, arrival_s=float(arrivals[i])))
    return reqs


__all__ = ["ContinuousBatcher", "Request", "ServeMetrics", "make_trace",
           "request_sampling_key"]
