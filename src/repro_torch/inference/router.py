"""The multi-replica serving router: the port of
``repro/inference/router.py``.

Past the all-reduce mitigations, the remaining throughput lever is data
parallelism over replicas.  A :class:`Router` places a request trace over N
self-contained replicas (each a
:class:`~repro_torch.inference.scheduler.ContinuousBatcher` or a
:class:`~repro_torch.inference.disagg.DisaggCoordinator` with its own
virtual mesh, autotune table and KV cache; on one card they share the
device) and owns placement only; each replica keeps its own scheduling.

* Placement is a pure function of load snapshots
  (:class:`ReplicaLoad`): queue depths and estimated costs on the logical
  step clock, never the wall clock, so a trace replays identically.
* A preempted request is recovered by its own replica (requeue first);
  the router never places it again.
* Replicas never interact, so a ``round_robin`` fleet is token-identical,
  request for request, to N single replicas each fed its share of the
  arrivals; ``make_injector`` folds the replica id into the fault plan's
  seed, so one replica's faults leave the others' tokens as they were.

``ttft_aware`` prices each queued prompt's prefill with the paper's
analytic machinery (:func:`prefill_cost_model`: projection GEMM flops over
a chip's sustained rate, plus two all-reduces a layer from
``core.comm_model`` at the replica's TP layout); only the order matters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .scheduler import Request, ServeMetrics
from .spec import ReplicaSpec, ServeSpec, build_replica, spec_config


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """One replica's admission state at a placement decision, on the
    logical clock and the token axis."""
    queue_depth: int            # due requests queued, not yet admitted
    queued_prompt_tokens: int   # their prompt tokens
    active: int                 # occupied decode slots (and requeued)
    slots: int                  # decode slots
    active_remaining: int       # decode tokens left over the active slots
    est_queue_cost: float = 0.0   # est. prefill seconds queued ahead
    est_active_cost: float = 0.0  # est. seconds until a slot frees


def place_round_robin(loads: Sequence[ReplicaLoad], rr: int) -> int:
    """Arrival index modulo the fleet size: the parity-bearing baseline."""
    return rr % len(loads)


def place_least_queue(loads: Sequence[ReplicaLoad], rr: int) -> int:
    """Fewest requests in flight (queued + active); ties to the lowest
    index."""
    return min(range(len(loads)),
               key=lambda i: (loads[i].queue_depth + loads[i].active, i))


def place_ttft_aware(loads: Sequence[ReplicaLoad], rr: int) -> int:
    """Smallest estimated wait to a first token: the prefill cost queued
    ahead, plus, when every slot is busy, the drain of the active decodes;
    queue depth breaks ties."""
    def key(i: int):
        ld = loads[i]
        c = ld.est_queue_cost
        if ld.slots and ld.active >= ld.slots:
            c += ld.est_active_cost
        return (c, ld.queue_depth + ld.active, i)
    return min(range(len(loads)), key=key)


POLICIES: Dict[str, Callable[[Sequence[ReplicaLoad], int], int]] = {
    "round_robin": place_round_robin,
    "least_queue": place_least_queue,
    "ttft_aware": place_ttft_aware,
}


# ---------------------------------------------------------------------------
# Analytic prefill cost
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A chip's GEMM roofline, the reference simulator's (``inference/
    simulator.py``) constants: peak bf16 rate, the M below which a GEMM
    gets no faster, the sustained share of peak."""
    name: str
    flops_bf16: float
    gemm_tile_m: int = 128
    efficiency: float = 0.55


A100 = ChipSpec("A100-80G", 312e12)
GH200 = ChipSpec("GH200", 989e12)
V5E = ChipSpec("TPUv5e", 197e12)
CHIP_FOR_NET = {"perlmutter": A100, "vista": GH200, "tpu_v5e": V5E}


def _layer_gemm_flops(cfg, m_tokens: int, tile_m: int) -> float:
    """A layer's projection GEMM flops for M tokens, M floored at the
    chip's tile."""
    m_eff = max(m_tokens, tile_m)
    d, hd = cfg.d_model, cfg.head_dim
    qkvo = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * d
    if cfg.is_moe:
        ff = 3 * d * cfg.d_ff_expert * cfg.top_k
    else:
        ff = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return 2.0 * m_eff * (qkvo + ff)


def prefill_cost_model(spec: ReplicaSpec, net=None,
                       chip=None) -> Callable[[int], float]:
    """``spec`` -> f(prompt tokens) -> estimated prefill seconds: the
    layers' projection flops over the chip's sustained bf16 rate, split
    ``tp`` ways, plus (tp > 1) two all-reduces a layer of the activation
    message at the best of NCCL's modeled algorithms for the (pods x
    tp/pods) layout.  The network defaults to the port's (Perlmutter, as
    its autotuner; ROADMAP §3), the chip to the network's."""
    from ..core.comm_model import PERLMUTTER, nccl_model_best
    cfg = spec_config(spec)
    tp = spec.prefill_tp if spec.disagg else spec.tp
    pods = spec.prefill_pods if spec.disagg else spec.pods
    if net is None:
        net = PERLMUTTER
    if chip is None:
        chip = CHIP_FOR_NET.get(net.name, V5E)
    itemsize = 2  # bf16 activations

    def cost(s_tokens: int) -> float:
        flops = cfg.n_layers * _layer_gemm_flops(cfg, s_tokens,
                                                 chip.gemm_tile_m)
        t = flops / (tp * chip.flops_bf16 * chip.efficiency)
        if tp > 1:
            msg = 2.0 * s_tokens * cfg.d_model * itemsize
            _, t_ar = nccl_model_best(msg, pods, tp // pods, net)
            t += cfg.n_layers * t_ar
        return t
    return cost


# ---------------------------------------------------------------------------
# Fleet metrics and the router
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RouterMetrics:
    """Per-replica metrics, their lossless merge (percentiles from the
    kept samples) and the placement counts."""
    replicas: int
    policy: str
    placements: List[int]
    load_imbalance: float          # max / mean of placements (1.0 even)
    fleet: Any                     # ServeMetrics | DisaggMetrics merge
    per_replica: List[Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"replicas": self.replicas, "policy": self.policy,
                "placements": list(self.placements),
                "load_imbalance": self.load_imbalance,
                "fleet": self.fleet.to_dict(),
                "per_replica": [m.to_dict() for m in self.per_replica]}


def _is_disagg(rep) -> bool:
    return hasattr(rep, "decode")


class Router:
    """Front end over N replicas on one logical clock: each tick, due
    arrivals are placed (the policy over :class:`ReplicaLoad` snapshots)
    onto per-replica queues the router owns, then every replica runs one
    ``tick(queue, now)``, the entry point its own ``run`` uses."""

    def __init__(self, replicas: Sequence[Any], policy: str = "round_robin",
                 cost_fn: Optional[Callable[[int], float]] = None):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(one of {tuple(POLICIES)})")
        self.replicas = list(replicas)
        if len({_is_disagg(r) for r in self.replicas}) > 1:
            raise ValueError("heterogeneous fleet: all replicas must be "
                             "batchers or all coordinators")
        self.policy = policy
        # without a cost model the prompt length stands in (monotone, all
        # ttft_aware needs)
        self.cost_fn = cost_fn if cost_fn is not None else float
        self.queues: List[List[Request]] = [[] for _ in self.replicas]
        self.placements = [0] * len(self.replicas)
        self.assigned: List[List[Request]] = [[] for _ in self.replicas]
        self._rr = 0

    @classmethod
    def from_spec(cls, spec: ServeSpec, *, ap=None, model=None,
                  device: Optional[str | torch.device] = None,
                  cuda_graph: bool = True) -> "Router":
        """The fleet a ``ServeSpec`` describes: N replicas of one template,
        each with its own virtual mesh(es) on the device and its own fault
        schedule (``replica_id`` folded into the plan's seed).  The
        replicas share one set of weights: replica 0's plan and model
        (each pool's, under ``disagg``) serve the others."""
        from ..parallel.topology import replica_device_groups
        spec.validate()
        rspec = spec.replica
        devices = replica_device_groups(spec.replicas, rspec.device_need,
                                        device or "cuda")
        reps: List[Any] = []
        for i, dev in enumerate(devices):
            kw: Dict[str, Any] = dict(ap=ap, model=model)
            if reps and _is_disagg(reps[0]):
                kw = dict(prefill_ap=reps[0].prefill.ap,
                          prefill_model=reps[0].prefill.model,
                          decode_ap=reps[0].decode.ap,
                          decode_model=reps[0].decode.model)
            elif reps:
                kw = dict(ap=reps[0].ap, model=reps[0].model)
            reps.append(build_replica(rspec, replica_id=i, device=dev,
                                      cuda_graph=cuda_graph, **kw))
        return cls(reps, policy=spec.router_policy,
                   cost_fn=prefill_cost_model(rspec))

    def _load(self, i: int) -> ReplicaLoad:
        rep = self.replicas[i]
        q = self.queues[i]
        dec = rep.decode if _is_disagg(rep) else rep
        # in-flight handoffs count as queued work
        inflight = len(rep._ready) if _is_disagg(rep) else 0
        active = sum(a is not None for a in dec.active) + len(dec._requeue)
        live = [int(dec.remaining[s]) for s, a in enumerate(dec.active)
                if a is not None]
        est_q = sum(self.cost_fn(len(r.prompt)) for r in q) \
            + inflight * self.cost_fn(1)
        # decode frees about one token a slot a step; cost_fn(1) prices
        # one such step
        est_a = min(live, default=0) * self.cost_fn(1)
        return ReplicaLoad(
            queue_depth=len(q) + inflight,
            queued_prompt_tokens=sum(len(r.prompt) for r in q),
            active=active, slots=dec.slots, active_remaining=sum(live),
            est_queue_cost=est_q, est_active_cost=est_a)

    def _place(self, req: Request) -> int:
        loads = [self._load(i) for i in range(len(self.replicas))]
        i = POLICIES[self.policy](loads, self._rr)
        self._rr += 1
        self.placements[i] += 1
        self.queues[i].append(req)
        self.assigned[i].append(req)
        return i

    def run(self, requests: List[Request],
            max_steps: int = 100000) -> List[Request]:
        """Replay a trace over the fleet (the contract of
        ``ContinuousBatcher.run``): placement at arrival, every replica
        ticked every step, drained when every queue, requeue and slot is
        empty."""
        waiting = sorted(requests, key=lambda r: r.arrival_s)
        qi = 0
        now = 0.0
        self.queues = [[] for _ in self.replicas]
        self.placements = [0] * len(self.replicas)
        self.assigned = [[] for _ in self.replicas]
        self._rr = 0
        for rep in self.replicas:
            if _is_disagg(rep):
                rep.begin_run()
            else:
                rep.reset_run_stats()
        wall0 = time.perf_counter()
        for _ in range(max_steps):
            while qi < len(waiting) and waiting[qi].arrival_s <= now:
                self._place(waiting[qi])
                qi += 1
            if qi >= len(waiting) and all(
                    rep.drained(q)
                    for rep, q in zip(self.replicas, self.queues)):
                break
            for rep, q in zip(self.replicas, self.queues):
                rep.tick(q, now)
            now += 1.0
        for rep in self.replicas:
            dev = (rep.decode if _is_disagg(rep) else rep).device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - wall0
        # the replicas share the loop: each gets the fleet's wall time
        for rep in self.replicas:
            if _is_disagg(rep):
                rep._wall = wall
                rep.decode._wall_run = wall
            else:
                rep._wall_run = wall
        return requests

    def metrics(self, requests: List[Request]) -> RouterMetrics:
        from .disagg import DisaggMetrics
        per = [rep.metrics(self.assigned[i])
               for i, rep in enumerate(self.replicas)]
        cls = DisaggMetrics if _is_disagg(self.replicas[0]) else ServeMetrics
        mean = sum(self.placements) / len(self.placements)
        return RouterMetrics(
            replicas=len(self.replicas), policy=self.policy,
            placements=list(self.placements),
            load_imbalance=max(self.placements) / mean if mean else 0.0,
            fleet=cls.merge(per), per_replica=per)


__all__ = ["Router", "RouterMetrics", "ReplicaLoad", "POLICIES",
           "place_round_robin", "place_least_queue", "place_ttft_aware",
           "prefill_cost_model", "ChipSpec", "CHIP_FOR_NET"]
