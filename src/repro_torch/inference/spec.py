"""The serving configuration as a value, ``ReplicaSpec`` / ``ServeSpec``,
and the one construction path from it: the port of
``repro/inference/spec.py``.

* :class:`ReplicaSpec`: one self-contained replica (model, mesh layout or
  per-pool layouts under ``disagg``, all-reduce knobs, KV layout,
  admission, sampling, speculation, robustness).  Frozen, hashable, JSON
  round-trippable.  It has the reference's fields and two of the port's:
  ``layers`` (cut the depth, widths kept) and ``overlap_chunks``.
* :class:`ServeSpec`: a deployment, the mode (batch | trace), the replica
  template, the replica count and the router's placement policy.
* ``validate``: the one home of the combination checks, with the
  reference's messages; the CLI, the factories and the router's replicas
  all call it.
* :func:`build_replica` turns a spec into a live
  :class:`~repro_torch.inference.scheduler.ContinuousBatcher` (colocated)
  or :class:`~repro_torch.inference.disagg.DisaggCoordinator` (``disagg``);
  :func:`build_engine` and :func:`build_prefill_pool` build the batch
  engine and a prefill pool.  Each builds its own virtual mesh(es) on the
  given device (``device=None``: the card).

``kv_quant`` (the int8 KV cache) builds where the reference builds it:
trace mode, full admission, the dense layout, no speculation, no prefix
cache, no disagg (``validate``, the reference's messages).
``seq_parallel`` shapes the prefill of the colocated batcher, of the
engine and of a disaggregated deployment's prefill pool; the decode pool
is built with it "off" (its prefill-shaped steps never run: it admits by
handoff), as in the reference.  What the reference accepts and builds but
the port has not ported is refused at build time: ``fsdp_serve`` waits for
ROADMAP item 11 (``NotImplementedError``); ``scan_layers`` is a compile
knob of the reference with nothing to choose here.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.pcontext import AR_QUANT_MODES, AR_STRATEGIES, SEQ_PARALLEL_MODES
from ..models.transformer import init_params, make_plan
from .engine import resolve_device

ROUTER_POLICIES = ("round_robin", "least_queue", "ttft_aware")

ADMIT_MODES = ("full", "chunked")
SPEC_MODES = (None, "ngram", "draft", "replay")
SERVE_MODES = ("batch", "trace")
PREFIX_MODES = ("off", "on")


class SpecError(ValueError):
    """An invalid ``ServeSpec`` / ``ReplicaSpec`` combination, raised by
    ``validate`` alike at the CLI, in the factories and for a router's
    replicas."""


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One self-contained serving replica (see the module docstring)."""
    arch: str
    smoke: bool = True
    layers: int = 0                      # > 0: cut the depth to this
    # -- mesh layout ------------------------------------------------------
    tp: int = 1
    pods: int = 1
    # -- all-reduce knobs -------------------------------------------------
    ar_strategy: str = "flat"
    ar_table: Optional[str] = None       # persisted autotune table path
    overlap: bool = False
    overlap_chunks: int = 4
    seq_parallel: str = "off"
    ar_quant: str = "none"
    # -- KV layout / admission -------------------------------------------
    slots: int = 4
    s_max: int = 128
    block_size: int = 0
    n_blocks: Optional[int] = None
    kv_quant: bool = False
    admit_mode: str = "full"
    admit_chunk: int = 32
    # -- prefix sharing ---------------------------------------------------
    prefix_cache: str = "off"
    prefix_capacity: Optional[int] = None
    # -- sampling ---------------------------------------------------------
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # -- step-builder knobs of the reference ------------------------------
    scan_layers: bool = True
    fsdp_serve: bool = False
    # -- speculative decoding ---------------------------------------------
    spec_mode: Optional[str] = None
    spec_k: int = 4
    spec_adaptive: bool = False
    draft_arch: str = "llama3.2-1b"
    spec_autodisable_after: int = 0
    # -- robustness -------------------------------------------------------
    fault_plan: Optional[str] = None     # 'k=v,...' string or JSON path
    deadline_ms: Optional[float] = None  # 1 logical step = 1 ms
    # -- disaggregated prefill / decode pools -----------------------------
    disagg: bool = False
    prefill_tp: int = 1
    prefill_pods: int = 1
    decode_tp: int = 1
    decode_pods: int = 1
    prefill_ar_table: Optional[str] = None
    decode_ar_table: Optional[str] = None
    # None: the prefill pool inherits ``block_size``; 0 forces a dense pool
    # in front of a paged decode pool (bundles are layout-independent)
    prefill_block_size: Optional[int] = None
    prefill_per_step: int = 1
    max_handoff_retries: int = 3
    retry_backoff: float = 1.0
    max_ready: Optional[int] = None
    max_reprefills: int = 2

    @property
    def device_need(self) -> int:
        """Ranks one replica's mesh holds: the TP degree, or the wider pool
        under ``disagg``."""
        return max(self.prefill_tp, self.decode_tp) if self.disagg \
            else self.tp

    def validate(self, mode: str = "trace") -> "ReplicaSpec":
        """Reject invalid combinations (:class:`SpecError`) for a replica
        serving under ``mode``; returns ``self``."""
        def bad(msg: str) -> None:
            raise SpecError(msg)

        if mode not in SERVE_MODES:
            bad(f"unknown mode={mode!r} (one of {SERVE_MODES})")
        if self.arch not in ARCH_IDS:
            bad(f"unknown arch={self.arch!r}")
        if self.ar_strategy not in AR_STRATEGIES:
            bad(f"unknown ar_strategy={self.ar_strategy!r}")
        if self.seq_parallel not in SEQ_PARALLEL_MODES:
            bad(f"unknown seq_parallel={self.seq_parallel!r}")
        if self.ar_quant not in AR_QUANT_MODES:
            bad(f"unknown ar_quant={self.ar_quant!r}")
        if self.admit_mode not in ADMIT_MODES:
            bad(f"unknown admit_mode={self.admit_mode!r}")
        if self.spec_mode not in SPEC_MODES:
            bad(f"unknown spec_mode={self.spec_mode!r}")
        if self.slots < 1:
            bad(f"slots={self.slots} must be >= 1")
        if self.tp < 1 or self.pods < 1:
            bad(f"tp={self.tp}/pods={self.pods} must be >= 1")
        if self.tp % self.pods:
            bad(f"tp={self.tp} not divisible by pods={self.pods}")
        if self.layers < 0:
            bad(f"layers={self.layers} must be >= 0")
        if self.admit_mode == "chunked" and self.s_max % self.admit_chunk:
            bad(f"s_max={self.s_max} must be a multiple of "
                f"admit_chunk={self.admit_chunk}")
        if self.spec_mode and self.spec_k < 1:
            bad(f"spec_k must be >= 1, got spec_k={self.spec_k}")
        if self.ar_quant == "auto" and self.ar_strategy != "auto":
            bad("ar_quant='auto' rides the per-call-site autotuner: it "
                "requires --ar-strategy auto / ar_strategy='auto' (got "
                f"ar_strategy={self.ar_strategy!r})")
        if mode == "batch":
            if self.spec_adaptive:
                bad("spec_adaptive is trace-mode only (the batch engine "
                    "runs a fixed spec_k)")
            if self.fault_plan or self.deadline_ms is not None:
                bad("fault_plan/deadline_ms are trace-mode only (the "
                    "batch engine has no recovery machinery)")
            if self.disagg:
                bad("disagg is trace-mode only")
            if self.kv_quant:
                bad("kv_quant is trace-mode only (the batch engine's "
                    "prefill builds an fp cache)")
            if self.block_size and self.tp > 1:
                bad("block_size with mode='batch' is local-path only "
                    "(use mode='trace' for mesh-path paging)")
            if self.prefix_cache != "off":
                bad("prefix_cache is trace-mode only (admission-time "
                    "prefix splicing; the batch engine prefills once)")
        if self.prefix_cache not in PREFIX_MODES:
            bad(f"unknown prefix_cache={self.prefix_cache!r} (one of "
                f"{PREFIX_MODES})")
        if self.prefix_cache == "on":
            if not self.block_size:
                bad("prefix_cache='on' needs the paged KV layout: set "
                    f"block_size > 0 (got block_size={self.block_size}) "
                    "— prefix sharing is per physical block")
            if self.kv_quant:
                bad("prefix_cache is incompatible with kv_quant (the "
                    "int8 cache is dense-layout, full-admission only)")
            if self.disagg:
                bad("prefix_cache is incompatible with disagg: the "
                    "decode pool admits via KV handoff, not prompts "
                    "(colocated trace serving only)")
            if self.admit_chunk < 1 or self.admit_chunk % self.block_size:
                bad(f"admit_chunk={self.admit_chunk} must be a positive "
                    f"multiple of block_size={self.block_size} for "
                    "prefix_cache (a spliced prefix must end on a chunk "
                    "boundary)")
            if self.s_max % self.admit_chunk:
                bad(f"s_max={self.s_max} must be a multiple of "
                    f"admit_chunk={self.admit_chunk} for prefix_cache "
                    "(hits prefill their suffix through the chunked "
                    "executables)")
            if self.prefix_capacity is not None \
                    and self.prefix_capacity < 1:
                bad(f"prefix_capacity={self.prefix_capacity} must be "
                    ">= 1 (or None for pool-bounded)")
            if get_smoke(self.arch).family != "dense":
                bad("prefix_cache rides the chunked suffix-prefill path: "
                    "dense (attention-only) families only, not "
                    f"arch={self.arch!r}")
        if self.kv_quant:
            if self.admit_mode == "chunked":
                bad("kv_quant is incompatible with admit_mode='chunked': "
                    "chunked prefill cannot re-read the int8 cache "
                    "mid-prompt (use admit_mode='full')")
            if self.block_size:
                bad("kv_quant is incompatible with block_size > 0 (paged "
                    "KV blocks are not scale-grouped); drop one of the "
                    "two")
            if self.spec_mode:
                bad("kv_quant is incompatible with spec_mode: the verify "
                    "pass rides chunked prefill over the int8 cache")
            if self.disagg:
                bad("kv_quant is incompatible with disagg: the KV "
                    "handoff ships fp states between pools")
        if self.disagg:
            if self.prefill_tp < 1 or self.decode_tp < 1:
                bad(f"prefill_tp={self.prefill_tp}/decode_tp="
                    f"{self.decode_tp} must be >= 1")
            if self.prefill_tp % self.prefill_pods:
                bad(f"prefill_tp={self.prefill_tp} not divisible by "
                    f"prefill_pods={self.prefill_pods}")
            if self.decode_tp % self.decode_pods:
                bad(f"decode_tp={self.decode_tp} not divisible by "
                    f"decode_pods={self.decode_pods}")
            if self.max_handoff_retries < 0 or self.max_reprefills < 0:
                bad("max_handoff_retries/max_reprefills must be >= 0")
        return self

    def replace(self, **kw) -> "ReplicaSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """A deployment: mode, replica template, fleet shape."""
    replica: ReplicaSpec
    mode: str = "trace"
    replicas: int = 1
    router_policy: str = "round_robin"

    def validate(self) -> "ServeSpec":
        if self.replicas < 1:
            raise SpecError(f"replicas={self.replicas} must be >= 1")
        if self.router_policy not in ROUTER_POLICIES:
            raise SpecError(f"unknown router_policy="
                            f"{self.router_policy!r} (one of "
                            f"{ROUTER_POLICIES})")
        if self.replicas > 1 and self.mode != "trace":
            raise SpecError("replicas > 1 is trace-mode only (the router "
                            "tier replays a request trace)")
        self.replica.validate(mode=self.mode)
        return self

    def replace(self, **kw) -> "ServeSpec":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_args(cls, ns) -> "ServeSpec":
        """A validated spec from a ``launch.serve`` namespace, the CLI's
        sentinels normalized (``spec_mode=None``, ``ar_quant='none'``)."""
        spec_mode = None if ns.spec_mode in (None, "none") else ns.spec_mode
        ar_quant = "none" if ns.ar_quant == "off" else ns.ar_quant
        replica = ReplicaSpec(
            arch=ns.arch, smoke=not ns.full, layers=ns.layers, tp=ns.tp,
            pods=ns.pods, ar_strategy=ns.ar_strategy, ar_table=ns.ar_table,
            overlap=ns.overlap, overlap_chunks=ns.overlap_chunks,
            seq_parallel=ns.seq_parallel,
            ar_quant=ar_quant, slots=ns.slots, s_max=ns.s_max,
            block_size=ns.block_size, n_blocks=ns.n_blocks,
            admit_mode=ns.admit_mode, admit_chunk=ns.admit_chunk,
            prefix_cache=ns.prefix_cache,
            prefix_capacity=ns.prefix_capacity, kv_quant=ns.kv_quant,
            temperature=ns.temperature, top_k=ns.top_k, seed=ns.seed,
            spec_mode=spec_mode, spec_k=ns.spec_k,
            spec_adaptive=ns.spec_adaptive, draft_arch=ns.draft_arch,
            fault_plan=ns.fault_plan, deadline_ms=ns.deadline_ms,
            disagg=ns.disagg, prefill_tp=ns.prefill_tp,
            prefill_pods=ns.prefill_pods, decode_tp=ns.decode_tp,
            decode_pods=ns.decode_pods,
            prefill_ar_table=ns.prefill_ar_table,
            decode_ar_table=ns.decode_ar_table,
            prefill_per_step=ns.prefill_per_step)
        return cls(replica=replica, mode=ns.mode, replicas=ns.replicas,
                   router_policy=ns.router_policy).validate()

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["replica"] = dataclasses.asdict(self.replica)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ServeSpec":
        """Inverse of :meth:`to_json`; unknown keys are an error (a
        mistyped field must not fall back to its default)."""
        d = json.loads(s)
        if not isinstance(d, dict):
            raise SpecError(f"spec JSON must be an object, got "
                            f"{type(d).__name__}")
        rd = d.pop("replica", None)
        if rd is None:
            raise SpecError("spec JSON is missing the 'replica' object")
        known_r = {f.name for f in dataclasses.fields(ReplicaSpec)}
        unknown = sorted(set(rd) - known_r)
        if unknown:
            raise SpecError(f"unknown ReplicaSpec field(s): {unknown}")
        known_s = {f.name for f in dataclasses.fields(cls)} - {"replica"}
        unknown = sorted(set(d) - known_s)
        if unknown:
            raise SpecError(f"unknown ServeSpec field(s): {unknown}")
        return cls(replica=ReplicaSpec(**rd), **d).validate()


# ---------------------------------------------------------------------------
# factories: the one construction path for every deployment shape
# ---------------------------------------------------------------------------


def spec_config(spec: ReplicaSpec):
    """The spec's model config: full or smoke, the depth cut to
    ``layers``."""
    cfg = get_smoke(spec.arch) if spec.smoke else get_config(spec.arch)
    if 0 < spec.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=spec.layers)
    return cfg


def _refuse_unported(spec: ReplicaSpec) -> None:
    if spec.fsdp_serve:
        raise NotImplementedError("fsdp_serve (weights sharded over fsdp "
                                  "axes) arrives with ROADMAP item 11")


def _layout(spec: ReplicaSpec, tp: int, pods: int, device,
            seq_parallel: Optional[str] = None):
    from ..parallel.topology import mesh_and_ctx
    return mesh_and_ctx(
        tp, pods, ar_strategy=spec.ar_strategy, overlap=spec.overlap,
        overlap_chunks=spec.overlap_chunks,
        seq_parallel=spec.seq_parallel if seq_parallel is None
        else seq_parallel, ar_quant=spec.ar_quant, device=device)


def _plan_model(spec: ReplicaSpec, tp: int, mesh, device, ap, model):
    """(ap, model) for a layout: the caller's, or the spec's seeded init
    (one seed is one function at every tp)."""
    if ap is None:
        ap = make_plan(spec_config(spec), tp)
    if model is None:
        model = init_params(ap, seed=spec.seed, device=device, mesh=mesh)
    return ap, model


def make_injector(spec: ReplicaSpec, replica_id: int = 0):
    """``spec.fault_plan`` -> a :class:`~repro_torch.inference.faults.
    FaultInjector` (None without a plan).  ``replica_id`` is folded into
    the plan's seed, so each replica of a fleet has its own schedule and
    one replica's faults never mirror onto another's requests."""
    if spec.fault_plan is None:
        return None
    from .faults import FaultInjector, FaultPlan
    plan = FaultPlan.parse(spec.fault_plan)
    if replica_id:
        plan = dataclasses.replace(plan, seed=plan.seed + 7919 * replica_id)
    return FaultInjector(plan)


def build_engine(spec: ReplicaSpec, *, ap=None, model=None, drafter=None,
                 device: Optional[str | torch.device] = None,
                 cuda_graph: bool = True):
    """``ReplicaSpec`` -> :class:`~repro_torch.inference.engine.
    InferenceEngine` (the batch path)."""
    from .engine import InferenceEngine
    spec.validate(mode="batch")
    _refuse_unported(spec)
    device = resolve_device(device)
    mesh, ctx, tp = _layout(spec, spec.tp, spec.pods, device)
    ap, model = _plan_model(spec, tp, mesh, device, ap, model)
    return InferenceEngine(
        ap, model, ctx=ctx, mesh=mesh, s_max=spec.s_max,
        temperature=spec.temperature, top_k=spec.top_k, seed=spec.seed,
        block_size=spec.block_size, ar_table=spec.ar_table,
        spec_mode=spec.spec_mode, spec_k=spec.spec_k,
        draft_arch=spec.draft_arch, drafter=drafter, device=device,
        cuda_graph=cuda_graph)


def build_prefill_pool(spec: ReplicaSpec, *, ap=None, model=None,
                       ar_table=None,
                       device: Optional[str | torch.device] = None,
                       cuda_graph: bool = True):
    """``ReplicaSpec`` -> :class:`~repro_torch.inference.disagg.
    PrefillPool` on the spec's prefill layout (``prefill_tp`` /
    ``prefill_pods``, its own virtual mesh).  ``ar_table`` overrides
    ``spec.prefill_ar_table`` (an already resolved ``pool_tuner``)."""
    from .disagg import PrefillPool, pool_tuner
    spec.validate(mode="trace")
    _refuse_unported(spec)
    device = resolve_device(device)
    mesh, ctx, tp = _layout(spec, spec.prefill_tp, spec.prefill_pods,
                            device)
    ap, model = _plan_model(spec, tp, mesh, device, ap, model)
    if ar_table is None:
        ar_table = pool_tuner(spec.prefill_ar_table or spec.ar_table)
    return PrefillPool(
        ap, model, s_max=spec.s_max, ctx=ctx, mesh=mesh, ar_table=ar_table,
        temperature=spec.temperature, top_k=spec.top_k, seed=spec.seed,
        admit_mode=spec.admit_mode, admit_chunk=spec.admit_chunk,
        block_size=spec.block_size if spec.prefill_block_size is None
        else spec.prefill_block_size, device=device, cuda_graph=cuda_graph)


def _build_batcher(spec: ReplicaSpec, *, ap, model, drafter, injector,
                   ar_table, seq_parallel, deadline, device, cuda_graph):
    from .scheduler import ContinuousBatcher
    mesh, ctx, tp = _layout(spec, spec.tp, spec.pods, device, seq_parallel)
    ap, model = _plan_model(spec, tp, mesh, device, ap, model)
    return ContinuousBatcher(
        ap, model, slots=spec.slots, s_max=spec.s_max, ctx=ctx, mesh=mesh,
        block_size=spec.block_size, n_blocks=spec.n_blocks,
        kv_quant=spec.kv_quant, ar_table=ar_table,
        temperature=spec.temperature, top_k=spec.top_k, seed=spec.seed,
        admit_mode=spec.admit_mode, admit_chunk=spec.admit_chunk,
        spec_mode=spec.spec_mode, spec_k=spec.spec_k,
        spec_adaptive=spec.spec_adaptive, draft_arch=spec.draft_arch,
        drafter=drafter, injector=injector, deadline_s=deadline,
        spec_autodisable_after=spec.spec_autodisable_after,
        prefix_cache=spec.prefix_cache,
        prefix_capacity=spec.prefix_capacity, device=device,
        cuda_graph=cuda_graph)


def build_replica(spec: ReplicaSpec, *, ap=None, model=None, drafter=None,
                  injector=None, replica_id: int = 0,
                  prefill_ap=None, prefill_model=None,
                  decode_ap=None, decode_model=None,
                  device: Optional[str | torch.device] = None,
                  cuda_graph: bool = True):
    """The one replica factory: ``ReplicaSpec`` -> ``ContinuousBatcher``
    (colocated) or ``DisaggCoordinator`` (``spec.disagg``), validated first
    so a router's replica refuses exactly as the CLI does.

    ``ap`` / ``model`` skip the plan and the seeded init (shared weights;
    under ``disagg`` used when both pools have one TP degree, else each
    pool draws its own from the spec's seed, the same function, unless
    ``prefill_*`` / ``decode_*`` are given).  ``injector`` overrides the one
    :func:`make_injector` derives from ``spec.fault_plan`` and
    ``replica_id``; under ``disagg`` it drives both the coordinator's
    handoff hooks and the decode batcher's step hooks."""
    spec.validate(mode="trace")
    _refuse_unported(spec)
    device = resolve_device(device)
    if injector is None:
        injector = make_injector(spec, replica_id)
    if not spec.disagg:
        return _build_batcher(
            spec, ap=ap, model=model, drafter=drafter, injector=injector,
            ar_table=spec.ar_table, seq_parallel=None,
            deadline=spec.deadline_ms, device=device, cuda_graph=cuda_graph)
    from .disagg import DisaggCoordinator, pool_tuner
    tuner_p = pool_tuner(spec.prefill_ar_table or spec.ar_table)
    tuner_d = pool_tuner(spec.decode_ar_table or spec.ar_table)
    shared = spec.prefill_tp == spec.decode_tp
    if prefill_ap is None:
        prefill_ap, prefill_model = (ap, model) if shared else (None, None)
    pool = build_prefill_pool(spec, ap=prefill_ap, model=prefill_model,
                              ar_table=tuner_p, device=device,
                              cuda_graph=cuda_graph)
    # the decode pool admits by handoff splice, never from prompts
    decode_spec = spec.replace(tp=spec.decode_tp, pods=spec.decode_pods,
                               admit_mode="full")
    if decode_ap is None:
        decode_ap, decode_model = (pool.ap, pool.model) if shared \
            else (None, None)
    decode = _build_batcher(
        decode_spec, ap=decode_ap, model=decode_model, drafter=drafter,
        injector=injector, ar_table=tuner_d, seq_parallel="off",
        deadline=None, device=device, cuda_graph=cuda_graph)
    return DisaggCoordinator(
        pool, decode, prefill_per_step=spec.prefill_per_step,
        decode_tuner=tuner_d, injector=injector,
        max_handoff_retries=spec.max_handoff_retries,
        retry_backoff=spec.retry_backoff, max_ready=spec.max_ready,
        max_reprefills=spec.max_reprefills, deadline_s=spec.deadline_ms)


__all__ = ["ReplicaSpec", "ServeSpec", "SpecError", "ROUTER_POLICIES",
           "PREFIX_MODES", "build_replica", "build_engine",
           "build_prefill_pool", "make_injector", "spec_config"]
