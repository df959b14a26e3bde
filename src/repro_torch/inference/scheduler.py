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
  a prompt length; it serves every text-only family (the encoder-decoder
  and the VLM are refused at construction: a request carries no frames
  or patches).  ``admit_mode="chunked"``
  (dense family) feeds the prompt through fixed chunks of ``admit_chunk``
  tokens instead (``build_admit_chunk_step``, kernel 3's chunk form over
  the slot's cache): one captured step for every prompt length.
* ``prefix_cache="on"`` (paged, dense) keeps the blocks of prefilled
  prompts in a :class:`~repro_torch.inference.prefix_cache.PrefixCache`
  trie: an admission splices the longest resident prefix (whole chunks)
  into its table and chunk-prefills only the suffix.
* ``spec_mode`` (dense) turns each step into draft + verify
  (``build_spec_verify_step``, one captured step a speculation length):
  every slot emits 1..k+1 tokens a step, the rejected tail's blocks go
  back through ``BlockAllocator.truncate``.
* With ``block_size > 0`` the K/V are paged: a host-side
  :class:`~repro_torch.inference.kv_cache.BlockAllocator` grows each
  slot's block list on demand and preempts (evicts and requeues) the
  youngest request when the pool runs dry; a preempted request is
  recomputed from scratch with its own sampling chain, so its tokens are
  those of an undisturbed run.  On a mesh every rank has its own pool of
  ``n_blocks``, read through one folded table (``transformer.fold_table``).
* Robustness: an ``injector``
  (:class:`~repro_torch.inference.faults.FaultInjector`) is consulted
  before each step (a NaN poked into a slot's live K, an OOM burst, a
  straggler's delay); a slot whose logits come back non-finite is
  quarantined (its K/V storage scrubbed, the request evicted and recomputed
  through the preemption path), and a request still waiting for its first
  admission past its deadline (``deadline_s``, ``Request.deadline_s``) is
  shed and reported.  Every write into the cache (the poke, a shared
  block's copy before the poke, the scrub, a handoff's splice) goes into
  the cache's own tensors, which the captured steps hold.
* :meth:`ContinuousBatcher.admit_prefilled` admits a context prefilled by
  another pool (``inference.disagg``): a checksummed
  :class:`~repro_torch.inference.kv_cache.KVBundle` spliced into a slot.

Scheduling time is a logical step clock (1.0 an engine step), so traces
replay deterministically; wall-clock times are recorded beside it for TTFT
and TPOT.
* ``kv_quant``: the int8 cache (int8 K/V, bf16 ``k_scale``/``v_scale``),
  dense layout and full admission only, with the reference's refusals.
  Every row operation moves the scale leaves with K/V
  (``transformer.KV_LEAVES``); the NaN poke writes into ``k_scale``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.pcontext import LOCAL, ParallelCtx
from ..models import layers as L
from ..models.transformer import KV_LEAVES, ArchPlan, DenseLM, fold_table
from ..parallel.steps import (ARTable, build_admit_chunk_step,
                              build_admit_step, build_cache_init,
                              build_kv_splice_step, build_serve_step,
                              build_spec_verify_step)
from .engine import resolve_device
from .faults import FaultInjector
from .kv_cache import BlockAllocator, KVBundle, bundle_states, paged_geometry
from .prefix_cache import PrefixCache
from .speculative import AdaptiveK, Drafter, make_drafter


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,)
    max_new: int
    arrival_s: float = 0.0       # logical (step-clock) arrival
    # TTFT deadline in logical steps from arrival (inf: none); a request
    # still waiting for its first admission past it is shed
    deadline_s: float = float("inf")
    # filled by the scheduler:
    first_token_s: float = -1.0  # wall-clock, relative to run() start
    done_s: float = -1.0         # wall-clock, relative to run() start
    admit_step: int = -1         # logical step of (last) admission
    done_step: int = -1
    preempted: int = 0           # times evicted and recomputed
    output: Optional[np.ndarray] = None
    # a shed request keeps output None and is reported with its reason
    shed_step: int = -1
    shed_reason: Optional[str] = None


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else float("nan")


def shed_request(shed: List[Request], req: Request, now: float,
                 reason: str) -> None:
    """Drop a never-admitted request and report it (``shed_reason``, the
    metrics' count): load control, never a silent loss."""
    req.shed_step = int(now)
    req.shed_reason = reason
    shed.append(req)


def ttft_deadline(req: Request, default: Optional[float]) -> float:
    """The request's TTFT deadline in logical steps: the tighter of its own
    and the server's ``default``."""
    return req.deadline_s if default is None else min(req.deadline_s,
                                                      default)


def request_sampling_key(seed: int, rid: int) -> Tuple[int, int]:
    """Base key of request ``rid``'s sampling chain: token t of the request
    is drawn at index t of it, a stateless chain keyed on the request, not
    on the step schedule, so a preempted request's recompute resamples its
    original tokens.  Temperature 0 never reads it."""
    return L.sampling_key(seed, rid)


def run_chunked_prefill(prompt: np.ndarray, slot: int, chunk: int,
                        mid: Any, final: Any, inputs: Dict[str, torch.Tensor],
                        key: Tuple[int, int], start_chunk: int = 0) -> int:
    """Drive a prompt through the chunked-prefill steps into cache row
    ``slot`` (the port of ``run_chunked_prefill``): the intermediate
    chunks through ``mid`` (no logits), the final one through ``final``,
    which samples the first token, token 0 of the chain ``key``, at
    in-chunk index ``(S-1) % chunk``; pads past the prompt's end are
    token 0.  The steps' ``inputs`` (``build_admit_chunk_step``) are
    filled in place before each call, so one captured step serves every
    length.  ``start_chunk`` skips the leading chunks whose K/V the slot's
    table already maps (a prefix-cache hit): chunk i writes the same values
    at the same positions wherever the loop starts.  Returns the first
    token."""
    S = int(prompt.shape[0])
    n_chunks = -(-S // chunk)
    if not 0 <= start_chunk < n_chunks:
        raise ValueError(f"start_chunk {start_chunk} of {n_chunks} chunks")
    padded = np.zeros((n_chunks * chunk,), np.int64)
    padded[:S] = prompt
    x = inputs
    x["slot"].fill_(slot)
    x["last"].fill_((S - 1) % chunk)
    x["key"].copy_(torch.tensor([key], dtype=torch.int64))
    for i in range(start_chunk, n_chunks):
        x["tokens"].copy_(torch.from_numpy(padded[None, i * chunk:
                                                  (i + 1) * chunk]))
        x["positions"].copy_(torch.arange(i * chunk, (i + 1) * chunk,
                                          dtype=torch.int32)[None])
        (mid if i < n_chunks - 1 else final)()
    return int(x["out"][0])


@dataclasses.dataclass
class ServeMetrics:
    """Trace-replay metrics.  TTFT (time to first token) and TPOT (time per
    output token) are counted in logical steps (admission wait plus the
    prefill's step for TTFT) and converted to seconds by the measured mean
    step time; ``throughput_tok_s`` is new tokens over the run's wall
    time.  ``wasted_tokens`` counts tokens decoded and then discarded by an
    eviction (preemption, injected OOM, quarantine).

    Robustness (zeros on a fault-free run): ``quarantines`` slots evicted
    on non-finite logits and recomputed; ``injected_oom`` growths denied by
    an injected burst (the growing slot evicted); ``shed_requests``
    requests shed on their deadline before admission (reported, with
    ``Request.shed_reason``); ``straggler_steps`` steps carrying an
    injected delay.

    Speculative decoding (zeros when ``spec_mode`` is off): ``spec_steps``
    verify passes; ``drafted_tokens`` / ``accepted_tokens`` and their
    ratio ``acceptance_rate``; ``accepted_tokens_per_step``, the mean
    verified drafts a verify pass over all slots (the per-step all-reduce
    amortization); ``drafter_hit_rate``, the share of drafts with a real
    candidate; ``spec_k_mean``, the mean speculation length;
    ``spec_autodisables``, slots degraded to plain decode.  Prefix cache
    (zeros when off): ``prefix_lookups`` admissions that consulted the
    trie, ``prefix_hits`` those that spliced at least one chunk,
    ``prefix_tokens_saved`` prompt tokens never prefilled, and
    ``prefix_hit_rate``.  The per-request TTFT and TPOT samples (steps)
    are kept for :meth:`merge` and left out of :meth:`to_dict`."""
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
    spec_steps: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    acceptance_rate: float = 0.0
    accepted_tokens_per_step: float = 0.0
    drafter_hit_rate: float = 0.0
    spec_k_mean: float = 0.0
    spec_autodisables: int = 0
    quarantines: int = 0
    injected_oom: int = 0
    shed_requests: int = 0
    straggler_steps: int = 0
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    prefix_hit_rate: float = 0.0
    ttft_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)
    tpot_steps_samples: List[float] = dataclasses.field(
        default_factory=list, repr=False)

    SAMPLE_FIELDS = ("ttft_steps_samples", "tpot_steps_samples")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in self.SAMPLE_FIELDS:
            d.pop(k, None)
        return d

    @classmethod
    def merge(cls, parts: List["ServeMetrics"]) -> "ServeMetrics":
        """A fleet's metrics from its replicas', losslessly: counters and
        totals summed, percentiles recomputed from the kept samples (never
        an average of p99s), ``steps`` and ``wall_s`` the max (one logical
        clock), footprints summed, ratios from summed numerators and
        denominators, ``cache_stats`` dropped."""
        if not parts:
            raise ValueError("merge() needs at least one ServeMetrics")
        def add(f):
            return sum(getattr(m, f) for m in parts)

        def wsum(f):
            return sum(getattr(m, f) * m.spec_steps for m in parts)

        ttft = [x for m in parts for x in m.ttft_steps_samples]
        tpot = [x for m in parts for x in m.tpot_steps_samples]
        steps = max(m.steps for m in parts)
        wall = max(m.wall_s for m in parts)
        step_s = wall / steps if steps else 0.0
        total_new, drafted, accepted, spec_steps, peak, lookups, hits = (
            add(f) for f in ("total_new_tokens", "drafted_tokens",
                             "accepted_tokens", "spec_steps",
                             "peak_kv_tokens", "prefix_lookups",
                             "prefix_hits"))
        occupied = sum(m.cache_utilization * m.peak_kv_tokens
                       for m in parts)

        return cls(
            requests=add("requests"), completed=add("completed"),
            total_new_tokens=total_new, steps=steps, wall_s=wall,
            throughput_tok_s=total_new / wall if wall > 0 else 0.0,
            ttft_steps_p50=_percentile(ttft, 50),
            ttft_steps_p99=_percentile(ttft, 99),
            tpot_steps_p50=_percentile(tpot, 50),
            tpot_steps_p99=_percentile(tpot, 99),
            ttft_s_p50=_percentile(ttft, 50) * step_s,
            ttft_s_p99=_percentile(ttft, 99) * step_s,
            tpot_s_p50=_percentile(tpot, 50) * step_s,
            tpot_s_p99=_percentile(tpot, 99) * step_s,
            preemptions=add("preemptions"), peak_kv_tokens=peak,
            kv_capacity_tokens=add("kv_capacity_tokens"),
            cache_utilization=occupied / peak if peak else 0.0,
            cache_stats=None, wasted_tokens=add("wasted_tokens"),
            spec_steps=spec_steps, drafted_tokens=drafted,
            accepted_tokens=accepted,
            acceptance_rate=accepted / drafted if drafted else 0.0,
            accepted_tokens_per_step=accepted / spec_steps
            if spec_steps else 0.0,
            drafter_hit_rate=wsum("drafter_hit_rate") / spec_steps
            if spec_steps else 0.0,
            spec_k_mean=wsum("spec_k_mean") / spec_steps
            if spec_steps else 0.0,
            spec_autodisables=add("spec_autodisables"),
            quarantines=add("quarantines"),
            injected_oom=add("injected_oom"),
            shed_requests=add("shed_requests"),
            straggler_steps=add("straggler_steps"),
            prefix_lookups=lookups, prefix_hits=hits,
            prefix_tokens_saved=add("prefix_tokens_saved"),
            prefix_hit_rate=hits / lookups if lookups else 0.0,
            ttft_steps_samples=ttft, tpot_steps_samples=tpot)


class ContinuousBatcher:
    """Slot-based continuous batching on the local or mesh path."""

    def __init__(self, ap: ArchPlan, model: DenseLM, *, slots: int = 8,
                 s_max: int = 512, ctx: ParallelCtx = LOCAL, mesh=None,
                 block_size: int = 0, n_blocks: Optional[int] = None,
                 kv_quant: bool = False, ar_table: ARTable = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 admit_mode: str = "full", admit_chunk: int = 32,
                 spec_mode: Optional[str] = None, spec_k: int = 4,
                 spec_adaptive: bool = False,
                 draft_arch: str = "llama3.2-1b",
                 drafter: Optional[Drafter] = None,
                 spec_autodisable_after: int = 0,
                 prefix_cache: str = "off",
                 prefix_capacity: Optional[int] = None,
                 injector: Optional[FaultInjector] = None,
                 deadline_s: Optional[float] = None,
                 device: Optional[str | torch.device] = None,
                 cuda_graph: bool = True):
        """``block_size > 0`` pages the K/V (a pool of ``n_blocks`` a rank,
        by default every slot at full length plus the trash block);
        ``temperature > 0`` samples from each request's chain under
        ``seed``; ``device=None`` runs on the card and raises if there is
        none.  ``cuda_graph=False`` keeps the card's steps eager.

        ``admit_mode="chunked"`` admits through chunks of ``admit_chunk``
        tokens (dense family; ``s_max`` a multiple of it).
        ``prefix_cache="on"`` (paged, dense; ``admit_chunk`` a multiple of
        ``block_size``) splices resident prompt prefixes (at most
        ``prefix_capacity`` held blocks) and chunk-prefills the suffix.
        ``spec_mode`` ("ngram", "draft" with ``draft_arch``, "replay", or
        an injected ``drafter``) drafts ``spec_k`` tokens a slot a step and
        verifies them in one pass (dense family); ``spec_adaptive`` walks k
        along {2, 4, 8} within [1, spec_k] by acceptance;
        ``spec_autodisable_after`` > 0 degrades a slot to plain decode
        after that many consecutive zero-accept passes; a quarantined
        slot's request is degraded too.

        ``injector`` (a :class:`~repro_torch.inference.faults.
        FaultInjector`) is consulted before each step: NaN poked into a
        slot's live K, an OOM burst, a straggler's delay.  ``deadline_s``
        is the default TTFT deadline in logical steps (a request's own
        ``deadline_s`` tightens it); a request still waiting for its first
        admission past it is shed and reported."""
        family = ap.cfg.family
        if family in ("encdec", "vlm"):
            raise ValueError(
                "the continuous batcher serves text-only archs, not "
                f"{family!r}: a request carries no frame or patch "
                "embeddings (the reference's batcher takes none either, "
                "and would decode an encoder-decoder slot over zeroed "
                "cross K/V); use InferenceEngine.generate(extra=)")
        if admit_mode not in ("full", "chunked"):
            raise ValueError(f"unknown admit_mode {admit_mode!r}")
        if admit_mode == "chunked" and family != "dense":
            raise ValueError("chunked admission needs an attention-only "
                             f"dense family, not {family!r}")
        if admit_mode == "chunked" and s_max % admit_chunk:
            raise ValueError(f"s_max={s_max} must be a multiple of "
                             f"admit_chunk={admit_chunk}")
        if prefix_cache not in ("off", "on"):
            raise ValueError(f"unknown prefix_cache {prefix_cache!r}")
        if prefix_cache == "on":
            if block_size <= 0 or ap.cfg.attn_free:
                raise ValueError("prefix_cache needs the paged KV layout "
                                 "(block_size > 0, attention family): "
                                 "sharing is per physical block")
            if family != "dense":
                raise ValueError("prefix_cache rides the chunked suffix "
                                 f"prefill: dense families only, not "
                                 f"{family!r}")
            if kv_quant:
                raise ValueError("prefix_cache is incompatible with "
                                 "kv_quant (int8 cache is dense-layout, "
                                 "full-admission only)")
            if admit_chunk < 1 or admit_chunk % block_size:
                raise ValueError(f"admit_chunk={admit_chunk} must be a "
                                 f"positive multiple of block_size="
                                 f"{block_size} for prefix_cache")
            if s_max % admit_chunk:
                raise ValueError(f"s_max={s_max} must be a multiple of "
                                 f"admit_chunk={admit_chunk} for "
                                 "prefix_cache")
        if kv_quant:
            # the reference's refusals (repro/inference/scheduler.py:417-431)
            if admit_mode == "chunked":
                raise ValueError("kv_quant needs full-prefill admission: "
                                 "chunked prefill cannot re-read the int8 "
                                 "cache mid-prompt")
            if block_size > 0 and not ap.cfg.attn_free:
                raise ValueError("kv_quant is incompatible with the paged "
                                 "KV layout (block_size > 0)")
            if spec_mode:
                raise ValueError("kv_quant is incompatible with "
                                 "speculative decoding (the verify pass "
                                 "rides chunked prefill)")
        if drafter is not None and not spec_mode:
            raise ValueError("an injected drafter needs spec_mode set")
        if spec_mode:
            if family != "dense":
                raise ValueError("speculative decoding rides the chunked-"
                                 "prefill verify path: dense families "
                                 f"only, not {family!r}")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
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
        self.kv_quant = kv_quant
        self.cache = build_cache_init(
            ap, ctx, mesh, slots=slots, s_max=s_max,
            block_size=self.block_size, n_blocks=n_blocks,
            kv_quant=kv_quant, device=self.device)()
        self._kv = [n for n in KV_LEAVES if n in self.cache]
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
        self._kw = dict(kw, cuda_graph=cuda_graph)
        self._serve, self._serve_out = build_serve_step(
            ap, ctx, mesh, model=self.model, cache=self.cache,
            state=self._state, s_max=s_max, cuda_graph=cuda_graph, **kw)
        self._admit_step = build_admit_step(ap, ctx, mesh, **kw)
        self.admit_mode = admit_mode
        self.admit_chunk = admit_chunk
        self.prefix: Optional[PrefixCache] = None
        self._chunk_steps: Tuple = ()
        if admit_mode == "chunked" or prefix_cache == "on":
            # the final chunk samples the first token, the others feed the
            # cache only; a prefix hit prefills its suffix through these
            # under admit_mode="full" too
            mid, self._chunk_in = build_admit_chunk_step(
                ap, ctx, mesh, model=self.model, cache=self.cache,
                chunk=admit_chunk, sample=False, **self._kw)
            final, _ = build_admit_chunk_step(
                ap, ctx, mesh, model=self.model, cache=self.cache,
                chunk=admit_chunk, inputs=self._chunk_in, **self._kw)
            self._chunk_steps = (mid, final)
        if prefix_cache == "on":
            self.prefix = PrefixCache(self.alloc, capacity=prefix_capacity)
        self._prefix_lookups = self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        # speculative decoding
        self.spec_mode = spec_mode
        self.spec_k = spec_k
        self.spec_autodisable_after = spec_autodisable_after
        self.drafter: Optional[Drafter] = None
        self._speck: Optional[AdaptiveK] = None
        self._spec_fns: Dict[int, Tuple] = {}  # k -> (step, drafts, out)
        if spec_mode:
            self.drafter = drafter if drafter is not None else make_drafter(
                spec_mode, draft_arch=draft_arch, seed=seed,
                device=self.device)
            if spec_adaptive:
                self._speck = AdaptiveK(ks=tuple(sorted(
                    {k2 for k2 in (2, 4, 8) if k2 <= spec_k} | {spec_k})))
        self._spec_steps = self._spec_drafted = 0
        self._spec_accepted = self._spec_k_sum = 0
        self._spec_autodisables = 0
        self._spec_deny: set = set()        # rids degraded to plain decode
        self._spec_zero_acc = np.zeros((slots,), np.int64)
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
        self._splice = build_kv_splice_step(ap, ctx, mesh)
        # robustness
        self.injector = injector
        self.deadline_s = deadline_s
        self._quarantines = self._injected_oom = 0
        self._straggler_steps = 0
        self._shed: List[Request] = []      # shed this run (reported)
        self._oom_now = False               # injected burst, this step only
        self._tainted: set = set()          # slots holding injected NaN

    def _captured(self) -> list:
        """Every captured step: serve, chunked admission, verify."""
        return [self._serve, *self._chunk_steps,
                *(f[0] for f in self._spec_fns.values())]

    @property
    def graph_replays(self) -> int:
        """Steps (serve, chunked admission, verify) replayed from their
        CUDA graphs so far."""
        return sum(c.replays for c in self._captured())

    @property
    def graph_recaptures(self) -> int:
        """Times a step was captured anew after an eager call grew an
        exchange buffer its graph held."""
        return sum(c.recaptures for c in self._captured())

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured so far (first captures and recaptures)."""
        return sum(c.captures for c in self._captured())

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

    def _prefix_match(self, prompt: np.ndarray) -> List[int]:
        """The longest resident prefix of ``prompt`` the suffix prefill can
        skip: whole ``admit_chunk`` multiples, at most S - 1 tokens (the
        final chunk always runs: it samples the first token).  Returns the
        physical blocks to splice."""
        S = int(prompt.shape[0])
        self._prefix_lookups += 1
        blocks = self.prefix.match(prompt)
        cap = ((S - 1) // self.admit_chunk) * self.admit_chunk
        shared = min(len(blocks) * self.block_size, cap)
        shared = (shared // self.admit_chunk) * self.admit_chunk
        return blocks[:shared // self.block_size]

    def _admit(self, slot: int, req: Request, now: float) -> bool:
        """Prefill one request into ``slot``.  Returns False when the paged
        pool cannot hold the prompt right now.

        With the prefix cache on, the longest resident prompt prefix is
        spliced first (``share``: references, no copy) and only the suffix
        is chunk-prefilled; then every block the prompt covers fully is
        published to the trie.  The share comes before any reclaim, so
        allocation pressure never evicts the blocks just matched."""
        S = int(req.prompt.shape[0])
        if S + 1 > self.s_max:
            raise ValueError(f"prompt len {S} + 1 exceeds s_max={self.s_max}")
        shared: List[int] = []
        if self.prefix is not None:
            shared = self._prefix_match(req.prompt)
            if shared:
                self.alloc.share(slot, shared)
        if self.alloc is not None:
            # +1: the first decode write lands at position S
            if self.prefix is not None \
                    and not self.alloc.can_allocate(slot, S + 1):
                need = self.alloc.blocks_for(S + 1) \
                    - len(self.alloc.owned(slot))
                self.prefix.reclaim(need - self.alloc.free_blocks)
            if not self.alloc.ensure(slot, S + 1):
                if shared:
                    self.alloc.free(slot)   # drop the references just taken
                return False
            self._sync_table()
        key = request_sampling_key(self.seed, req.rid)
        if shared or self.admit_mode == "chunked":
            n_shared = len(shared) * self.block_size
            if shared:
                self._prefix_hits += 1
                self._prefix_tokens_saved += n_shared
            tok = run_chunked_prefill(
                req.prompt, slot, self.admit_chunk, *self._chunk_steps,
                self._chunk_in, key, start_chunk=n_shared // self.admit_chunk)
        else:
            tok = int(self._admit_step(
                self.model, self.cache,
                torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                device=self.device), slot,
                torch.tensor([key], dtype=torch.int64,
                             device=self.device))[0])
        if self.prefix is not None:
            # publish before activation (max_new == 1 releases the slot
            # there): blocks whose positions are all prompt; decode writes
            # land at >= S, never in them
            n_pub = S // self.block_size
            if n_pub:
                self.prefix.insert(req.prompt,
                                   self.alloc.owned(slot)[:n_pub])
        self._activate(slot, req, tok, S, now, key)
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
        if self.drafter is not None:
            self.drafter.reset(slot, list(req.prompt) + [nxt])
        self._spec_zero_acc[slot] = 0   # the collapse streak is per occupant
        self._admit_seq[slot] = self._seq
        self._seq += 1
        self.outputs[req.rid] = [nxt]
        req.admit_step = int(now)
        req.first_token_s = time.perf_counter() - self._wall0
        self._dirty = True
        if self.remaining[slot] == 0:   # max_new == 1: prefill token only
            self._release(slot, now)

    def admit_prefilled(self, slot: int, req: Request, bundle: KVBundle,
                        first_token: int, now: float) -> bool:
        """Handoff admission (disaggregated serving): splice a bundle
        prefilled by another pool (canonical real-head layout) into
        ``slot`` and activate the request with its first token, sampled
        there.  Returns False, changing nothing, when the paged pool cannot
        hold the context now (the coordinator keeps it queued).  Raises
        :class:`~repro_torch.inference.kv_cache.BundleIntegrityError`,
        before any change, when a sealed bundle fails its checksum."""
        bundle.verify()
        S = bundle.n_tokens
        if S + 1 > self.s_max:
            raise ValueError(f"handoff len {S} + 1 exceeds s_max="
                             f"{self.s_max}")
        if self.alloc is not None:
            # +1: the first decode write lands at position S
            if not self.alloc.ensure(slot, S + 1):
                return False
            self._sync_table()
        k, v = bundle_states(bundle, self.ap.gqa.kv_map, self.ap.gqa.u,
                             self.device)
        self._splice(self.cache, k, v, slot)
        # continue the prefill pool's chain (bundle.rng); a producer that
        # never samples leaves it None and the chain is recomputed
        key = request_sampling_key(self.seed, req.rid) if bundle.rng is None \
            else tuple(int(x) for x in bundle.rng)
        self._activate(slot, req, int(first_token), S, now, key)
        return True

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
        scratch (capacity preemption, an injected OOM burst, quarantine);
        the recompute replays the request's own sampling chain, so its
        tokens are those of an undisturbed run.  A slot holding injected
        NaN is scrubbed first."""
        if slot in self._tainted:
            self._scrub_slot(slot)
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

    def _quarantine(self, slot: int) -> None:
        """Non-finite logits in ``slot``: its token of this step is
        dropped, the slot is evicted and the request recomputed exactly
        through the preemption path; under spec decoding its speculation
        is switched off for good (a drafter fed on poisoned history is not
        trusted again)."""
        self._quarantines += 1
        if self.spec_mode:
            rid = self.active[slot].rid
            if rid not in self._spec_deny:
                self._spec_deny.add(rid)
                self._spec_autodisables += 1
        self._evict(slot)

    def _folded(self, index: int, per_rank: int) -> torch.Tensor:
        """The R rows of the rank-folded cache that hold slot (dense,
        ``per_rank`` = slots) or physical block (paged, ``per_rank`` =
        n_blocks) ``index``, one a rank."""
        return torch.arange(self.R, device=self.device) * per_rank + index

    def _poison_slot(self, slot: int) -> None:
        """Injected fault: NaN into the slot's most recently written K
        position, every layer, every rank's copy, so the device step itself
        produces non-finite logits and the finite flag must catch them.  A
        shared or trie-held block is first forked (``fork_for_write``, the
        block copied into a fresh one on every rank), so the poke hits
        only its victim; with no block to fork into, the injection is
        skipped.  Written in place: the captured steps read this storage."""
        p = max(int(self.positions[slot]) - 1, 0)
        if "k" not in self.cache:
            # the ssm family keeps no K/V: its live state is the recurrence,
            # which the recompute's admission overwrites whole
            self.cache["wkv"][:, self._folded(slot, self.slots)] = \
                float("nan")
            return
        if self.paged:
            bidx = p // self.block_size
            if not self.alloc.is_exclusive(slot, bidx):
                if not self.alloc.free_blocks and self.prefix is not None:
                    self.prefix.reclaim(1)
                if not self.alloc.free_blocks:
                    return
                old, new = self.alloc.fork_for_write(slot, bidx)
                src = self._folded(old, self.n_blocks)
                dst = self._folded(new, self.n_blocks)
                for n in self._kv:
                    self.cache[n][:, dst] = self.cache[n][:, src]
                self._sync_table()
            rows = self._folded(int(self.alloc.table[slot, bidx]),
                                self.n_blocks)
            off = p % self.block_size
        else:
            rows, off = self._folded(slot, self.slots), p
        # the int8 cache holds no NaN: its scale does (the reference's
        # jnp.asarray(nan, int8) raises; ROADMAP §3)
        poked = "k_scale" if "k_scale" in self.cache else "k"
        self.cache[poked][:, rows, off] = float("nan")
        self._tainted.add(slot)

    def _scrub_slot(self, slot: int) -> None:
        """Zero a tainted slot's K/V storage before it is freed.  The
        poisoned step writes NaN K and V at its position in every layer
        past the first, and a plain attention version (the CPU's) sums
        ``0 * NaN`` over masked rows, so a freed block would poison its
        next occupant past that occupant's write frontier; zeros are safe
        on both sides of the mask.  Paged: only the slot's exclusive
        blocks (it never writes a shared one: the poke forks first, and a
        shared block holds its sharers' live prompt K/V).  In place, on
        every rank's copy."""
        if self.paged:
            rows = [self._folded(b, self.n_blocks)
                    for i, b in enumerate(self.alloc.owned(slot))
                    if self.alloc.is_exclusive(slot, i)]
        else:
            rows = [self._folded(slot, self.slots)]
        if rows:
            rows = torch.cat(rows)
            for n in self._kv:
                self.cache[n].index_fill_(1, rows, 0)
        self._tainted.discard(slot)

    def _ensure_growth(self, slot: int,
                       n_tokens: Optional[int] = None) -> None:
        """Blocks cover the slot's next write position (or ``n_tokens``
        positions: a verify chunk's whole write range); on a dry pool,
        cold trie blocks are reclaimed first, then requests preempted
        youngest-first until the growth fits (the growing slot itself may
        be the victim).  Under an injected OOM burst a growth that needs a
        new block is denied instead: the growing slot alone is evicted and
        recomputed once the burst has passed."""
        if n_tokens is None:
            n_tokens = int(self.positions[slot]) + 1
        if self._oom_now and self.alloc.needs_growth(slot, n_tokens):
            self._injected_oom += 1
            self._evict(slot)
            return
        while not self.alloc.ensure(slot, n_tokens):
            if self.prefix is not None:
                need = self.alloc.blocks_for(n_tokens) \
                    - len(self.alloc.owned(slot))
                if self.prefix.reclaim(need - self.alloc.free_blocks) > 0:
                    continue
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
        """One engine step over all slots (no-op when none is active): a
        draft + verify step under ``spec_mode``, else a decode step."""
        if self.spec_mode:
            return self._spec_step(now)
        return self._plain_step(now)

    def _pre_step_faults(self, now: float) -> None:
        """The injector's hooks for this step: arm the OOM burst (read by
        ``_ensure_growth``), poison the live slots it picks, apply the
        straggler's wall-clock delay (the logical clock is untouched)."""
        inj = self.injector
        self._oom_now = False
        if inj is None:
            return
        self._oom_now = inj.oom_burst(now)
        for s in range(self.slots):
            if not self.active_mask[s]:
                continue
            req = self.active[s]
            if inj.poison_slot(req.rid, len(self.outputs[req.rid])):
                self._poison_slot(s)
        d = inj.straggle(now)
        if d >= 0.0:
            self._straggler_steps += 1
            if d > 0.0:
                time.sleep(d)

    def _plain_step(self, now: float, faults_done: bool = False):
        """One decode step (``faults_done``: the spec step ran this step's
        fault hooks before falling back here)."""
        if not self.active_mask.any():
            return
        if not faults_done:
            self._pre_step_faults(now)
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
        self._note_occupancy()
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
                # this step's token is garbage: recompute the request
                self._quarantine(s)
                continue
            self.outputs[self.active[s].rid].append(int(emitted[s]))
            self.tokens[s] = emitted[s]
            self.positions[s] += 1
            self.remaining[s] -= 1
            self.sample_idx[s] += 1
            if self.alloc is not None:
                self.alloc.note_usage(s, int(self.positions[s]))
            if done[s]:
                self._release(s, now)

    def _note_occupancy(self) -> None:
        occ = int(self.positions[self.active_mask].sum()) + \
            int(self.active_mask.sum())
        self._peak_occupied = max(self._peak_occupied, occ)

    # -- speculative decoding ------------------------------------------------

    def _spec_fn(self, k: int) -> Tuple:
        """(step, drafts, out) of the verify step of length k, built and
        captured at its first use."""
        fn = self._spec_fns.get(k)
        if fn is None:
            fn = build_spec_verify_step(
                self.ap, self.ctx, self.mesh, model=self.model,
                cache=self.cache, state=self._state, k=k, **self._kw)
            self._spec_fns[k] = fn
        return fn

    def _spec_step(self, now: float):
        """One draft + verify step over all slots, the port of the
        reference's ``_spec_step``: each active slot drafts k tokens, the
        C = k + 1 chunk [token, drafts] of every slot is scored in one
        pass, the slot takes its verified prefix plus one correction or
        bonus token (capped by its budget and the cache), and the
        rejected tail's blocks go back to the pool.  The host slot state
        is authoritative (each slot advances by its own count) and is
        pushed every step.  A slot in ``_spec_deny`` (degraded by
        ``spec_autodisable_after``) drafts nothing and takes only the
        correction token; when every active slot is denied the step is a
        plain decode step.  A verify step with non-finite logits
        quarantines the slot and switches its speculation off."""
        if not self.active_mask.any():
            return
        self._pre_step_faults(now)
        if not self.active_mask.any():
            return
        denied = np.array([self.active_mask[s]
                           and self.active[s].rid in self._spec_deny
                           for s in range(self.slots)])
        if denied[self.active_mask].all():
            return self._plain_step(now, faults_done=True)
        k = self._speck.k if self._speck is not None else self.spec_k
        C = k + 1
        drafts = np.zeros((self.slots, k), np.int32)
        for s in range(self.slots):
            if self.active_mask[s] and not denied[s]:
                # a cross-vocabulary drafter must still propose valid ids
                drafts[s] = np.clip(self.drafter.draft(s, k), 0,
                                    self.cfg.vocab_size - 1)
        if self.alloc is not None:
            for s in range(self.slots):
                # the verify chunk writes [p, p + C): cover it up front
                # (positions past s_max go to the trash block)
                if self.active_mask[s]:
                    self._ensure_growth(s, min(int(self.positions[s]) + C,
                                               self.s_max))
            if not self.active_mask.any():
                return
        self._note_occupancy()
        if self._dirty:
            self._push_state()
        was_active = self.active_mask.copy()
        step, drafts_dev, out = self._spec_fn(k)
        drafts_dev.copy_(torch.from_numpy(drafts))
        step()
        res = out.cpu().numpy()
        emitted, accepted, finite = res[:, :C], res[:, C], res[:, C + 1]
        self.steps_run += 1
        self._spec_steps += 1
        self._spec_k_sum += k
        n_active = acc_sum = 0
        for s in range(self.slots):
            if not was_active[s]:
                continue
            if not finite[s]:
                self._quarantine(s)
                continue
            a = int(accepted[s])
            # where sequential decode would have stopped emitting; a slot
            # admitted at s_max - 1 still decodes once
            take = min(a + 1, int(self.remaining[s]),
                       max(self.s_max - 1 - int(self.positions[s]), 1))
            if denied[s]:
                take = min(take, 1)
            toks = [int(t) for t in emitted[s, :take]]
            self.outputs[self.active[s].rid].extend(toks)
            self.tokens[s] = toks[-1]
            self.positions[s] += take
            self.remaining[s] -= take
            self.sample_idx[s] += take
            if not denied[s]:
                self.drafter.observe(s, toks)
                n_active += 1
                acc_sum += a
                self._spec_drafted += k
                self._spec_accepted += a
                if self.spec_autodisable_after > 0:
                    self._spec_zero_acc[s] = 0 if a \
                        else self._spec_zero_acc[s] + 1
                    if self._spec_zero_acc[s] \
                            >= self.spec_autodisable_after:
                        self._spec_deny.add(self.active[s].rid)
                        self._spec_autodisables += 1
            if self.alloc is not None:
                # blocks holding only rejected drafts go back to the pool
                self.alloc.truncate(s, int(self.positions[s]))
                self.alloc.note_usage(s, int(self.positions[s]))
            if self.remaining[s] <= 0 \
                    or self.positions[s] >= self.s_max - 1:
                self._release(s, now)
        if self.alloc is not None:
            self._sync_table()
        self._dirty = True
        if self._speck is not None and n_active:
            self._speck.update(acc_sum / n_active, k)

    # -- trace replay --------------------------------------------------------

    def reset_run_stats(self) -> None:
        """Reset per-run accounting so :meth:`metrics` reflects one trace;
        slot ownership is untouched."""
        self.steps_run = 0
        self._peak_occupied = 0
        self.outputs = {}
        self._wasted_tokens = 0
        self._preemptions = 0
        self._spec_steps = self._spec_drafted = 0
        self._spec_accepted = self._spec_k_sum = 0
        self._spec_autodisables = 0
        self._spec_deny = set()
        self._spec_zero_acc[:] = 0
        self._quarantines = self._injected_oom = 0
        self._straggler_steps = 0
        self._shed = []
        self._tainted = set()
        if self.injector is not None:
            self.injector.reset_stats()
        # the trie itself persists across runs (warm reuse is the feature)
        self._prefix_lookups = self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        if self.drafter is not None:
            self.drafter.calls = self.drafter.hits = 0
        if self.alloc is not None:
            self.alloc.reset_stats()
        self._wall0 = time.perf_counter()

    def tick(self, arrived: List[Request], now: float) -> None:
        """One logical tick over a queue of due arrivals (mutated in place,
        also by a router that owns it): shed the arrivals past their
        deadline, admit (preempted requests first, then arrivals, FCFS),
        then run one engine step.  A preempted request is never shed: its
        first token was already given."""
        for r in [r for r in arrived
                  if now - r.arrival_s > ttft_deadline(r, self.deadline_s)]:
            shed_request(self._shed, r, now, "deadline")
            arrived.remove(r)
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
        for n in self._kv:
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
            cache_stats=cache_stats, wasted_tokens=self._wasted_tokens,
            spec_steps=self._spec_steps,
            drafted_tokens=self._spec_drafted,
            accepted_tokens=self._spec_accepted,
            acceptance_rate=self._spec_accepted / self._spec_drafted
            if self._spec_drafted else 0.0,
            accepted_tokens_per_step=self._spec_accepted / self._spec_steps
            if self._spec_steps else 0.0,
            drafter_hit_rate=self.drafter.hit_rate
            if self.drafter is not None else 0.0,
            spec_k_mean=self._spec_k_sum / self._spec_steps
            if self._spec_steps else 0.0,
            spec_autodisables=self._spec_autodisables,
            quarantines=self._quarantines,
            injected_oom=self._injected_oom,
            shed_requests=len(self._shed),
            straggler_steps=self._straggler_steps,
            prefix_lookups=self._prefix_lookups,
            prefix_hits=self._prefix_hits,
            prefix_tokens_saved=self._prefix_tokens_saved,
            prefix_hit_rate=self._prefix_hits / self._prefix_lookups
            if self._prefix_lookups else 0.0,
            ttft_steps_samples=ttft, tpot_steps_samples=tpot)


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


def make_prefix_trace(n_requests: int, *, prefix_len: int,
                      shared_frac: float, mean_in: int, mean_out: int,
                      rate: float, burstiness: float = 2.0, vocab: int = 97,
                      seed: int = 0,
                      clip_len: Optional[int] = None) -> List[Request]:
    """A :func:`make_trace` trace whose ``shared_frac`` share of requests
    open with one common ``prefix_len``-token system prompt, the workload
    the prefix cache serves.  Which requests share is a fixed-seed uniform
    draw against the threshold, so a larger ``shared_frac`` only adds
    shared requests; ``clip_len`` cuts prompts (their unique tail) to fit
    ``s_max - 1``."""
    rng = np.random.default_rng(seed + 0x5afe)
    shared = rng.integers(0, vocab, prefix_len).astype(np.int32)
    u = rng.random(n_requests)
    reqs = make_trace(n_requests, mean_in=mean_in, mean_out=mean_out,
                      rate=rate, burstiness=burstiness, vocab=vocab,
                      seed=seed)
    for i, r in enumerate(reqs):
        if u[i] < shared_frac:
            r.prompt = np.concatenate([shared, r.prompt]).astype(np.int32)
        if clip_len is not None and r.prompt.shape[0] > clip_len:
            r.prompt = r.prompt[:clip_len]
    return reqs


__all__ = ["ContinuousBatcher", "Request", "ServeMetrics", "make_trace",
           "make_prefix_trace", "run_chunked_prefill",
           "request_sampling_key"]
