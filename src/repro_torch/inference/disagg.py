"""Disaggregated prefill / decode serving, two pools at two operating
points: the port of ``repro/inference/disagg.py``.

Prefill sends large per-layer all-reduce messages (prompt x d_model), decode
small ones (slots x d_model), which sit at opposite ends of the paper's
strategy crossover.  Here each phase has its own pool:

* a :class:`PrefillPool` runs prompt prefills only, on its own virtual mesh
  (its own ``tp``/pods, exchange workspace and autotune table), and hands
  each context over as a layout-neutral, checksummed
  :class:`~repro_torch.inference.kv_cache.KVBundle` with its first token,
  already sampled;
* a decode-side :class:`~repro_torch.inference.scheduler.ContinuousBatcher`
  (its own mesh and table) splices bundles in through
  ``ContinuousBatcher.admit_prefilled``; the bundle's real-head form makes
  the pools' TP degrees independent;
* the :class:`DisaggCoordinator` sits between them: it admits arrivals to
  the prefill pool, moves finished contexts over the handoff queue into
  free decode slots, routes decode-pool preemptions back to the prefill
  pool, and under an injector retries dropped transfers with backoff,
  re-prefills corrupt bundles, sheds past ``max_reprefills`` or a
  deadline, and bounds the handoff queue under decode stalls.

Bars: a disaggregated greedy trace equals colocated paged serving of the
same trace (also with spec decoding on the decode pool, a dense decode
pool, and pools of different TP in f32), since a slot's tokens depend only
on its prompt and its K/V and the handoff converts no dtype; sampled plain
decode equals too, since the request's chain key travels in the bundle.
The handoff moves bundles through host memory (one device round trip), in
place of a network transport.  Dense family only (recurrent states are not
handed off).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import autotune
from ..core.pcontext import LOCAL, ParallelCtx
from ..models.transformer import ArchPlan, DenseLM
from ..parallel.steps import (ARTable, build_admit_chunk_step,
                              build_cache_init, build_prefill_only_step)
from .engine import resolve_device
from .faults import FaultInjector
from .kv_cache import (BundleIntegrityError, KVBundle, export_slot,
                       states_bundle)
from .scheduler import (ContinuousBatcher, Request, _percentile,
                        request_sampling_key, run_chunked_prefill,
                        shed_request, ttft_deadline)


def pool_tuner(ar_table: ARTable) -> autotune.AutoTuner:
    """A pool's own dispatch table: an AutoTuner or a path through
    ``autotune.tuner_for``; None gives a fresh analytic tuner on the active
    one's network, never the process-wide one, so each pool's lookups (the
    message buckets it dispatched on) stay its own.  A missing path is an
    error here."""
    if isinstance(ar_table, str) and not os.path.exists(ar_table):
        raise FileNotFoundError(f"pool ar_table not found: {ar_table!r}")
    if ar_table is not None:
        return autotune.tuner_for(ar_table)
    base = autotune.active()
    return autotune.AutoTuner(base.net, allow_lossy=base.allow_lossy)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PrefillPool:
    """Prefill-only pool: prompt in, (first token, sealed KVBundle) out.

    ``admit_mode="full"``: one eager ``build_prefill_only_step`` a prompt,
    the bundle packed from the states it returns.  ``"chunked"``: the
    prompt through the captured chunked-prefill steps into a private
    one-slot cache (``block_size`` > 0: paged, the identity table), the
    bundle exported from it.  Both give the same bundle in f32."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *, s_max: int,
                 ctx: ParallelCtx = LOCAL, mesh=None,
                 ar_table: ARTable = None, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, admit_mode: str = "full",
                 admit_chunk: int = 32, block_size: int = 0,
                 device: Optional[str | torch.device] = None,
                 cuda_graph: bool = True):
        self.ap, self.cfg = ap, ap.cfg
        if self.cfg.family != "dense":
            raise ValueError("disaggregated serving supports attention-"
                             f"only dense families, not "
                             f"{self.cfg.family!r}")
        if admit_mode not in ("full", "chunked"):
            raise ValueError(f"unknown admit_mode {admit_mode!r}")
        if admit_mode == "chunked" and s_max % admit_chunk:
            raise ValueError(f"s_max={s_max} must be a multiple of "
                             f"admit_chunk={admit_chunk}")
        self.s_max = s_max
        self.ctx = ctx
        self.mesh = mesh
        self.admit_mode = admit_mode
        self.admit_chunk = admit_chunk
        self.block_size = block_size
        self.seed = seed
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tuner = pool_tuner(ar_table)
        kw = dict(temperature=temperature, top_k=top_k, ar_table=self.tuner)
        self._full = build_prefill_only_step(ap, ctx, mesh, **kw) \
            if admit_mode == "full" else None
        self._chunk_steps: Tuple = ()
        self.cache = None
        if admit_mode == "chunked":
            # a private one-slot cache: n_blocks=None gives the identity
            # table at full capacity, so no allocator (one request at a
            # time, overwritten in place)
            self.cache = build_cache_init(ap, ctx, mesh, slots=1,
                                          s_max=s_max, block_size=block_size,
                                          device=self.device)()
            mid, self._chunk_in = build_admit_chunk_step(
                ap, ctx, mesh, model=self.model, cache=self.cache,
                chunk=admit_chunk, sample=False, cuda_graph=cuda_graph, **kw)
            final, _ = build_admit_chunk_step(
                ap, ctx, mesh, model=self.model, cache=self.cache,
                chunk=admit_chunk, inputs=self._chunk_in,
                cuda_graph=cuda_graph, **kw)
            self._chunk_steps = (mid, final)
            if block_size > 0:
                self._table_row = 1 + np.arange(s_max // block_size)
        self.reset_stats()

    @property
    def graph_captures(self) -> int:
        return sum(c.captures for c in self._chunk_steps)

    @property
    def graph_recaptures(self) -> int:
        return sum(c.recaptures for c in self._chunk_steps)

    def prefill(self, req: Request) -> Tuple[int, KVBundle]:
        """Run one request's prompt; return (first token, sealed bundle).
        The first token is token 0 of the request's chain, and the chain's
        key rides the bundle."""
        S = int(req.prompt.shape[0])
        if S + 1 > self.s_max:
            raise ValueError(f"prompt len {S} + 1 exceeds s_max="
                             f"{self.s_max}")
        t0 = time.perf_counter()
        kv_map = self.ap.gqa.kv_map
        key = request_sampling_key(self.seed, req.rid)
        if self.admit_mode == "full":
            tok, k, v = self._full(
                self.model, torch.as_tensor(req.prompt[None],
                                            dtype=torch.int64,
                                            device=self.device),
                torch.tensor([key], dtype=torch.int64, device=self.device))
            tok = int(tok[0])
            bundle = states_bundle(k, v, kv_map)
        else:
            tok = run_chunked_prefill(req.prompt, 0, self.admit_chunk,
                                      *self._chunk_steps, self._chunk_in,
                                      key)
            row = self._table_row if self.block_size > 0 else None
            bundle = export_slot(self.cache, 0, S, kv_map, table_row=row)
        bundle.rng = np.asarray(key, np.int64)
        bundle.seal()
        self.prefills += 1
        self.prompt_tokens += S
        self.wall_s += time.perf_counter() - t0
        # the per-layer all-reduce message of this prefill: (1, S, D) whole,
        # (1, admit_chunk, D) a chunk (pads included)
        msg = S if self.admit_mode == "full" else self.admit_chunk
        self.analytic_buckets.add(autotune.bucket_of(
            msg * self.cfg.d_model * _itemsize(self.cfg.dtype)))
        return tok, bundle

    def reset_stats(self) -> None:
        self.prefills = 0
        self.prompt_tokens = 0
        self.wall_s = 0.0
        self.analytic_buckets: set = set()

    def stats(self) -> Dict[str, Any]:
        return {
            "prefills": self.prefills,
            "prompt_tokens": self.prompt_tokens,
            "wall_s": self.wall_s,
            "mean_prompt_len": self.prompt_tokens / self.prefills
            if self.prefills else 0.0,
            "ar_buckets_analytic": sorted(self.analytic_buckets),
            "ar_buckets_dispatched": self.tuner.lookup_buckets(),
            "graph_captures": self.graph_captures,
            "graph_recaptures": self.graph_recaptures,
        }


@dataclasses.dataclass
class _Handoff:
    """A prefilled context in the handoff queue: ``attempts`` failed
    transfers of this bundle (the retry cap), ``next_try`` the backoff
    horizon (logical steps), ``prefill_no`` which prefill of the request
    made the payload (corruption is the payload's, keyed here)."""
    req: Request
    tok: int
    bundle: KVBundle
    prefill_no: int
    attempts: int = 0
    next_try: float = 0.0


@dataclasses.dataclass
class DisaggMetrics:
    """Disaggregated trace metrics with per-pool attribution: TTFT splits
    into the prefill pool's part (wait + prefill tick) and the transfer
    (handoff-queue wait); TPOT is the decode pool's.  ``*_ar_bucket``: each
    pool's all-reduce operating point, the largest log2 message bucket its
    tuner dispatched on (or, with no lookups, the analytic bucket of its
    per-layer message).  Robustness counters (zeros on a fault-free run):
    dropped transfer attempts and retries, corrupt bundles detected and
    re-prefills, shed requests, backpressure ticks (a full handoff queue
    holding prompts), stalled ticks of each pool."""
    requests: int
    completed: int
    total_new_tokens: int
    steps: int
    wall_s: float
    throughput_tok_s: float
    ttft_steps_p50: float
    ttft_steps_p99: float
    prefill_steps_p50: float
    transfer_steps_p50: float
    tpot_steps_p50: float
    tpot_steps_p99: float
    preemptions: int
    handoffs: int
    transfer_bytes: int
    peak_ready_depth: int        # bundles waiting for a decode slot
    peak_pending_depth: int      # prompts waiting for the prefill pool
    prefill_ar_bucket: int
    decode_ar_bucket: int
    prefill_pool: Dict[str, Any]
    decode_pool: Dict[str, Any]
    handoff_drops: int = 0
    handoff_retries: int = 0
    handoff_corrupt: int = 0
    handoff_reprefills: int = 0
    shed_requests: int = 0
    backpressure_steps: int = 0
    prefill_stall_steps: int = 0
    decode_stall_steps: int = 0
    ready_cap: int = 0
    ttft_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)
    prefill_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)
    transfer_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)
    tpot_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)

    SAMPLE_FIELDS = ("ttft_steps_samples", "prefill_steps_samples",
                     "transfer_steps_samples", "tpot_steps_samples")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in self.SAMPLE_FIELDS:
            d.pop(k, None)
        return d

    @classmethod
    def merge(cls, parts: List["DisaggMetrics"]) -> "DisaggMetrics":
        """A fleet's metrics: counters summed, percentiles recomputed from
        the kept samples, ``steps`` / ``wall_s`` / queue peaks / buckets
        the max, the per-pool dicts dropped."""
        if not parts:
            raise ValueError("merge() needs at least one DisaggMetrics")
        ttft = [x for m in parts for x in m.ttft_steps_samples]
        pre = [x for m in parts for x in m.prefill_steps_samples]
        xfer = [x for m in parts for x in m.transfer_steps_samples]
        tpot = [x for m in parts for x in m.tpot_steps_samples]
        wall = max(m.wall_s for m in parts)
        total_new = sum(m.total_new_tokens for m in parts)

        def add(f):
            return sum(getattr(m, f) for m in parts)

        def top(f):
            return max(getattr(m, f) for m in parts)

        return cls(
            requests=add("requests"), completed=add("completed"),
            total_new_tokens=total_new, steps=top("steps"), wall_s=wall,
            throughput_tok_s=total_new / wall if wall > 0 else 0.0,
            ttft_steps_p50=_percentile(ttft, 50),
            ttft_steps_p99=_percentile(ttft, 99),
            prefill_steps_p50=_percentile(pre, 50),
            transfer_steps_p50=_percentile(xfer, 50),
            tpot_steps_p50=_percentile(tpot, 50),
            tpot_steps_p99=_percentile(tpot, 99),
            preemptions=add("preemptions"), handoffs=add("handoffs"),
            transfer_bytes=add("transfer_bytes"),
            peak_ready_depth=top("peak_ready_depth"),
            peak_pending_depth=top("peak_pending_depth"),
            prefill_ar_bucket=top("prefill_ar_bucket"),
            decode_ar_bucket=top("decode_ar_bucket"),
            prefill_pool={}, decode_pool={},
            handoff_drops=add("handoff_drops"),
            handoff_retries=add("handoff_retries"),
            handoff_corrupt=add("handoff_corrupt"),
            handoff_reprefills=add("handoff_reprefills"),
            shed_requests=add("shed_requests"),
            backpressure_steps=add("backpressure_steps"),
            prefill_stall_steps=add("prefill_stall_steps"),
            decode_stall_steps=add("decode_stall_steps"),
            ready_cap=top("ready_cap"),
            ttft_steps_samples=ttft, prefill_steps_samples=pre,
            transfer_steps_samples=xfer, tpot_steps_samples=tpot)


class DisaggCoordinator:
    """Between a :class:`PrefillPool` and a decode-side
    :class:`ContinuousBatcher`, on the batcher's logical step clock: each
    tick sheds the requests past their deadline, lets the prefill pool
    (unless stalled or backpressured) prefill up to ``prefill_per_step``
    prompts, moves due handoffs into free decode slots, and runs one decode
    step (unless stalled).  ``decode`` should be built with its own tuner
    (:func:`pool_tuner`), passed as ``decode_tuner`` so the metrics report
    its buckets."""

    def __init__(self, prefill: PrefillPool, decode: ContinuousBatcher, *,
                 prefill_per_step: int = 1,
                 decode_tuner: Optional[autotune.AutoTuner] = None,
                 injector: Optional[FaultInjector] = None,
                 max_handoff_retries: int = 3, retry_backoff: float = 1.0,
                 max_ready: Optional[int] = None, max_reprefills: int = 2,
                 deadline_s: Optional[float] = None):
        """A dropped transfer attempt is retried after ``retry_backoff *
        attempts`` steps, up to ``max_handoff_retries`` retries; past that,
        or on a checksum mismatch at splice time, the context is
        re-prefilled from the prompt, up to ``max_reprefills`` times, and
        then the request is shed (``"handoff_failed"`` /
        ``"handoff_corrupt"``): every path ends.  ``max_ready`` bounds the
        handoff queue (default ``max(2 * decode.slots, 8)``); a full queue
        holds prompts back.  ``deadline_s``: the default TTFT deadline in
        logical steps; a never-admitted request past it is shed
        (``"deadline"``)."""
        if prefill.cfg.name != decode.cfg.name:
            raise ValueError(f"pool configs differ: {prefill.cfg.name!r} "
                             f"vs {decode.cfg.name!r}")
        if decode.cfg.family != "dense":
            raise ValueError("disaggregated serving supports dense "
                             f"families only, not {decode.cfg.family!r}")
        if prefill.s_max > decode.s_max:
            raise ValueError(f"prefill s_max={prefill.s_max} exceeds "
                             f"decode s_max={decode.s_max}; oversized "
                             f"prefills could never hand off")
        if max_handoff_retries < 0 or max_reprefills < 0:
            raise ValueError("retry/re-prefill caps must be >= 0")
        self.prefill = prefill
        self.decode = decode
        self.prefill_per_step = prefill_per_step
        self.decode_tuner = decode_tuner
        self.injector = injector
        self.max_handoff_retries = max_handoff_retries
        self.retry_backoff = retry_backoff
        self.max_ready = max_ready if max_ready is not None \
            else max(2 * decode.slots, 8)
        self.max_reprefills = max_reprefills
        self.deadline_s = deadline_s
        self._wall = 0.0
        self.begin_run(reset_pools=False)

    def _reprefill_or_shed(self, h: _Handoff, pending: List[Request],
                           now: float, reason: str) -> None:
        """After a handoff gave up (retries spent, or the payload corrupt):
        recompute the context from the prompt (front of the prefill queue),
        at most ``max_reprefills`` times, then shed.  The re-prefill replays
        the request's chain, so a recovered request's tokens are the
        fault-free run's."""
        n = self._reprefills.get(h.req.rid, 0)
        if n >= self.max_reprefills:
            shed_request(self._shed, h.req, now, reason)
            return
        self._reprefills[h.req.rid] = n + 1
        self.handoff_reprefills += 1
        pending.insert(0, h.req)

    def begin_run(self, reset_pools: bool = True) -> None:
        """Reset every per-run record, counter and queue (and the pools'
        statistics) before a trace: called by :meth:`run`, and by a router
        that ticks this coordinator itself."""
        self._records: Dict[int, Dict[str, float]] = {}
        self.transfer_bytes = 0
        self.handoffs = 0
        self.peak_ready = 0
        self.peak_pending = 0
        self.handoff_drops = self.handoff_retries = 0
        self.handoff_corrupt = self.handoff_reprefills = 0
        self.backpressure_steps = 0
        self.prefill_stall_steps = self.decode_stall_steps = 0
        self._shed: List[Request] = []
        self._reprefills: Dict[int, int] = {}
        self._ready: List[_Handoff] = []
        self._attempt_no: Dict[int, int] = {}
        self._prefill_no: Dict[int, int] = {}
        if reset_pools:
            self.decode.reset_run_stats()
            self.prefill.reset_stats()

    def _tick_pre(self, pending: List[Request], now: float) -> None:
        """The phases before the decode step: deadline sheds, the prefill
        phase (stall-checked even with nothing to prefill: a stall belongs
        to the tick), and the handoff drain into free decode slots."""
        inj = self.injector
        decode = self.decode
        ready = self._ready
        for r in [r for r in pending
                  if now - r.arrival_s > ttft_deadline(r, self.deadline_s)]:
            shed_request(self._shed, r, now, "deadline")
            pending.remove(r)
        for h in [h for h in ready if now - h.req.arrival_s
                  > ttft_deadline(h.req, self.deadline_s)]:
            shed_request(self._shed, h.req, now, "deadline")
            ready.remove(h)
        if inj is not None and inj.prefill_stalled(now):
            self.prefill_stall_steps += 1
        else:
            for _ in range(self.prefill_per_step):
                if not pending:
                    break
                if len(ready) >= self.max_ready:
                    self.backpressure_steps += 1
                    break
                req = pending.pop(0)
                n = self._prefill_no.get(req.rid, 0)
                self._prefill_no[req.rid] = n + 1
                tok, bundle = self.prefill.prefill(req)
                if inj is not None and inj.corrupt_handoff(req.rid, n):
                    FaultInjector.corrupt_bundle(bundle)
                rec = self._records.setdefault(
                    req.rid, {"arrival": req.arrival_s})
                rec["prefill_step"] = now
                self.handoffs += 1
                self.transfer_bytes += bundle.nbytes
                ready.append(_Handoff(req, tok, bundle, prefill_no=n))
        # handoff queue -> free decode slots, FIFO among the due entries; a
        # bundle the paged pool cannot hold now stays queued (head of line)
        for s in range(decode.slots):
            if decode.active[s] is not None:
                continue
            h = next((h for h in ready if h.next_try <= now), None)
            if h is None:
                continue
            a = self._attempt_no.get(h.req.rid, 0)
            self._attempt_no[h.req.rid] = a + 1
            if inj is not None and inj.drop_handoff(h.req.rid, a):
                self.handoff_drops += 1
                h.attempts += 1
                if h.attempts > self.max_handoff_retries:
                    ready.remove(h)
                    self._reprefill_or_shed(h, pending, now,
                                            "handoff_failed")
                else:
                    self.handoff_retries += 1
                    h.next_try = now + self.retry_backoff * h.attempts
                continue
            try:
                ok = decode.admit_prefilled(s, h.req, h.bundle, h.tok, now)
            except BundleIntegrityError:
                # the payload itself is bad: retrying it cannot succeed
                self.handoff_corrupt += 1
                ready.remove(h)
                self._reprefill_or_shed(h, pending, now, "handoff_corrupt")
                continue
            if ok:
                ready.remove(h)
                self._records[h.req.rid]["handoff_step"] = now
        self.peak_ready = max(self.peak_ready, len(ready))
        self.peak_pending = max(self.peak_pending, len(pending))

    def _tick_decode(self, pending: List[Request], now: float) -> None:
        """One decode-pool step (unless stalled), then its preemptions
        routed back to the front of the prompt queue, in eviction order:
        their K/V is gone and the prefill pool recomputes it."""
        inj = self.injector
        if inj is not None and inj.decode_stalled(now):
            self.decode_stall_steps += 1
        else:
            self.decode.step(now)
        if self.decode._requeue:
            pending[:0] = self.decode._requeue
            self.decode._requeue.clear()

    def tick(self, arrived: List[Request], now: float) -> None:
        """One logical tick on a prompt queue the caller owns: the
        ``ContinuousBatcher.tick`` contract, so a router drives both
        alike."""
        self._tick_pre(arrived, now)
        self._tick_decode(arrived, now)

    def drained(self, arrived: List[Request]) -> bool:
        """No queued, in-flight or active work left."""
        return not arrived and not self._ready \
            and all(a is None for a in self.decode.active)

    def run(self, requests: List[Request],
            max_steps: int = 100000) -> List[Request]:
        """Replay a trace (the contract of ``ContinuousBatcher.run``):
        every failed or corrupt handoff walks the bounded retry ->
        re-prefill -> shed ladder, so the run ends at any fault rate."""
        waiting = sorted(requests, key=lambda r: r.arrival_s)
        qi = 0
        now = 0.0
        pending: List[Request] = []
        self.begin_run()
        wall0 = time.perf_counter()
        for _ in range(max_steps):
            while qi < len(waiting) and waiting[qi].arrival_s <= now:
                pending.append(waiting[qi])
                qi += 1
            self._tick_pre(pending, now)
            if qi >= len(waiting) and self.drained(pending):
                break
            self._tick_decode(pending, now)
            now += 1.0
        if self.decode.device.type == "cuda":
            torch.cuda.synchronize(self.decode.device)
        self._wall = time.perf_counter() - wall0
        self.decode._wall_run = self._wall
        return requests

    # -- metrics -------------------------------------------------------------

    def _decode_bucket(self) -> int:
        """The decode pool's operating point: its tuner's lookups, else the
        analytic bucket of its per-layer message (slots x d_model, x (k+1)
        under spec verify)."""
        if self.decode_tuner is not None:
            seen = self.decode_tuner.lookup_buckets()
            if seen:
                return max(seen)
        cfg = self.decode.cfg
        tokens = self.decode.slots
        if self.decode.spec_mode:
            tokens *= self.decode.spec_k + 1
        return autotune.bucket_of(tokens * cfg.d_model * _itemsize(cfg.dtype))

    def _prefill_bucket(self) -> int:
        seen = self.prefill.tuner.lookup_buckets()
        if seen:
            return max(seen)
        return max(self.prefill.analytic_buckets, default=0)

    def metrics(self, requests: List[Request]) -> DisaggMetrics:
        dm = self.decode.metrics(requests)
        done = [r for r in requests if r.output is not None]
        pre, xfer, ttft = [], [], []
        for r in done:
            rec = self._records.get(r.rid)
            if rec is None or "handoff_step" not in rec:
                continue
            p = max(rec["prefill_step"] - rec["arrival"], 0.0) + 1.0
            t = rec["handoff_step"] - rec["prefill_step"]
            pre.append(p)
            xfer.append(t)
            ttft.append(p + t)
        decode_pool = dm.to_dict()
        decode_pool.update(graph_captures=self.decode.graph_captures,
                           graph_recaptures=self.decode.graph_recaptures)
        return DisaggMetrics(
            requests=len(requests), completed=len(done),
            total_new_tokens=dm.total_new_tokens, steps=dm.steps,
            wall_s=self._wall,
            throughput_tok_s=dm.total_new_tokens / self._wall
            if self._wall > 0 else 0.0,
            ttft_steps_p50=_percentile(ttft, 50),
            ttft_steps_p99=_percentile(ttft, 99),
            prefill_steps_p50=_percentile(pre, 50),
            transfer_steps_p50=_percentile(xfer, 50),
            tpot_steps_p50=dm.tpot_steps_p50,
            tpot_steps_p99=dm.tpot_steps_p99,
            preemptions=dm.preemptions, handoffs=self.handoffs,
            transfer_bytes=self.transfer_bytes,
            peak_ready_depth=self.peak_ready,
            peak_pending_depth=self.peak_pending,
            prefill_ar_bucket=self._prefill_bucket(),
            decode_ar_bucket=self._decode_bucket(),
            prefill_pool=self.prefill.stats(), decode_pool=decode_pool,
            handoff_drops=self.handoff_drops,
            handoff_retries=self.handoff_retries,
            handoff_corrupt=self.handoff_corrupt,
            handoff_reprefills=self.handoff_reprefills,
            shed_requests=len(self._shed),
            backpressure_steps=self.backpressure_steps,
            prefill_stall_steps=self.prefill_stall_steps,
            decode_stall_steps=self.decode_stall_steps,
            ready_cap=self.max_ready,
            ttft_steps_samples=ttft, prefill_steps_samples=pre,
            transfer_steps_samples=xfer,
            tpot_steps_samples=list(dm.tpot_steps_samples))


__all__ = ["PrefillPool", "DisaggCoordinator", "DisaggMetrics",
           "pool_tuner"]
