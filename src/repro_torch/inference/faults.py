"""Deterministic fault injection for the serving stack: the port's own copy
of ``repro/inference/faults.py``.

The paper's operating point is multi-node, where transient faults (dropped
or corrupted KV transfers, stalled pools, non-finite activations, allocator
pressure) are routine.  A :class:`FaultPlan` gives a rate per fault kind;
a :class:`FaultInjector` is consulted at explicit hook points:

* ``ContinuousBatcher`` (each step): ``poison_slot`` (NaN poked into a
  slot's live K, so the device step itself produces non-finite logits),
  ``oom_burst`` (block growth fails for the step), ``straggle`` (a
  wall-clock delay; the logical clock is untouched);
* ``DisaggCoordinator`` (each tick): ``drop_handoff``, ``corrupt_handoff``
  (with :meth:`FaultInjector.corrupt_bundle`, caught by the bundle's
  checksum at splice time), ``prefill_stalled`` / ``decode_stalled``.

Every decision is a pure function of ``(plan.seed, kind, ids)``: the crc32
of the same ``repr`` as the reference's, so a plan fires on the same events
in both packages, a schedule replays identically, and the event set at
rate r1 is a subset of the one at r2 >= r1.  The consumers own the
recovery (retry, re-prefill, quarantine and recompute, shedding) and
jointly keep the invariant: every non-shed greedy request's tokens are
bitwise the fault-free run's, and a shed request is reported, never lost.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Dict

import numpy as np
import torch

# fault kinds an injector counts (stats() keys, in reporting order)
FAULT_KINDS = ("handoff_drop", "handoff_corrupt", "prefill_stall",
               "decode_stall", "straggler", "nan_logits", "oom")
_RATES = ("handoff_drop", "handoff_corrupt", "prefill_stall",
          "decode_stall", "straggler", "nan_logits", "oom")


def hash_unit(seed: int, kind: str, *ids: int) -> float:
    """Deterministic uniform draw in [0, 1) from (seed, kind, ids): crc32
    of the repr, stable across processes and platforms, and stateless, so
    the schedule does not depend on the order of evaluation."""
    h = zlib.crc32(repr((int(seed), kind) + tuple(int(i) for i in ids))
                   .encode())
    return h / 2.0 ** 32


@dataclasses.dataclass
class FaultPlan:
    """Seedable description of a fault workload (every rate in [0, 1]).

    * ``handoff_drop``: per handoff transfer attempt (rid, attempt); the
      attempt is lost and retried with backoff.
    * ``handoff_corrupt``: per prefill of a request (rid, prefill no.);
      the bundle is damaged in flight, the checksum catches it at splice
      time and the coordinator re-prefills.
    * ``prefill_stall`` / ``decode_stall``: per window of ``stall_steps``
      ticks; the pool freezes for the whole window.
    * ``straggler``: per decode step; a wall-clock delay of
      ``straggler_s`` (never a token change).
    * ``nan_logits``: per (request, tokens emitted); a NaN is poked into
      the request's live K, fired at most once a key, so the recompute is
      not poisoned again.
    * ``oom``: per step; block growth fails as if the pool ran dry, and
      the growing slots are evicted and recomputed.
    """

    seed: int = 0
    handoff_drop: float = 0.0
    handoff_corrupt: float = 0.0
    prefill_stall: float = 0.0
    decode_stall: float = 0.0
    stall_steps: int = 3
    straggler: float = 0.0
    straggler_s: float = 0.0
    nan_logits: float = 0.0
    oom: float = 0.0

    def __post_init__(self):
        for f in _RATES:
            v = float(getattr(self, f))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault rate {f}={v} outside [0, 1]")
            setattr(self, f, v)
        if int(self.stall_steps) < 1:
            raise ValueError(f"stall_steps must be >= 1, got "
                             f"{self.stall_steps}")
        self.stall_steps = int(self.stall_steps)
        self.seed = int(self.seed)

    @property
    def any_faults(self) -> bool:
        return any(getattr(self, f) > 0.0 for f in _RATES)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """A plan from a ``k=v,k=v`` string or a JSON file's path (the
        ``--fault-plan`` flag takes either)."""
        if os.path.exists(spec):
            with open(spec) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError(f"fault plan {spec!r} must hold a JSON "
                                 f"object, got {type(doc).__name__}")
            return cls(**doc)
        kw: Dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad fault-plan entry {part!r} "
                                 f"(want key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in fields:
                raise ValueError(f"unknown fault-plan key {k!r}; known: "
                                 f"{sorted(fields)}")
            kw[k] = int(v) if k in ("seed", "stall_steps") else float(v)
        return cls(**kw)


class FaultInjector:
    """Hook-point decisions and the count of each kind that fired.  One
    injector serves one run; :meth:`reset_stats` re-arms it (decisions are
    stateless, so a reset replays the same schedule)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._nan_fired: set = set()

    def reset_stats(self) -> None:
        self.counts = {k: 0 for k in FAULT_KINDS}
        self._nan_fired = set()

    def stats(self) -> Dict[str, int]:
        return dict(self.counts)

    def _fire(self, kind: str, rate: float, *ids: int) -> bool:
        if rate <= 0.0:
            return False
        hit = hash_unit(self.plan.seed, kind, *ids) < rate
        if hit:
            self.counts[kind] += 1
        return hit

    # -- handoff hooks (DisaggCoordinator) ---------------------------------

    def drop_handoff(self, rid: int, attempt: int) -> bool:
        """Lose transfer attempt ``attempt`` of request ``rid``?"""
        return self._fire("handoff_drop", self.plan.handoff_drop,
                          rid, attempt)

    def corrupt_handoff(self, rid: int, prefill_no: int) -> bool:
        """Damage the bundle of ``rid``'s ``prefill_no``-th prefill?  Keyed
        per prefill, not per attempt: a corrupt payload stays corrupt
        across retries, and only a re-prefill makes a clean one."""
        return self._fire("handoff_corrupt", self.plan.handoff_corrupt,
                          rid, prefill_no)

    def prefill_stalled(self, step: float) -> bool:
        """Is the prefill pool frozen at logical ``step``?  Stalls take
        whole windows of ``stall_steps`` ticks."""
        return self._fire("prefill_stall", self.plan.prefill_stall,
                          int(step) // self.plan.stall_steps)

    def decode_stalled(self, step: float) -> bool:
        """Is the decode pool frozen at logical ``step``?"""
        return self._fire("decode_stall", self.plan.decode_stall,
                          int(step) // self.plan.stall_steps)

    # -- decode hooks (ContinuousBatcher) ----------------------------------

    def straggle(self, step: float) -> float:
        """Wall-clock delay in seconds for this step; -1.0 for none."""
        if self._fire("straggler", self.plan.straggler, int(step)):
            return max(self.plan.straggler_s, 0.0)
        return -1.0

    def poison_slot(self, rid: int, emitted: int) -> bool:
        """Poke a NaN into request ``rid``'s live K now that it has emitted
        ``emitted`` tokens?  Once a (rid, emitted) key: the recompute walks
        the same progress values again and must not be poisoned forever."""
        if self.plan.nan_logits <= 0.0:
            return False
        key = (int(rid), int(emitted))
        if key in self._nan_fired:
            return False
        if hash_unit(self.plan.seed, "nan_logits", *key) \
                < self.plan.nan_logits:
            self._nan_fired.add(key)
            self.counts["nan_logits"] += 1
            return True
        return False

    def oom_burst(self, step: float) -> bool:
        """Does block growth fail for the whole logical ``step``?"""
        return self._fire("oom", self.plan.oom, int(step))

    # -- payload damage -----------------------------------------------------

    @staticmethod
    def corrupt_bundle(bundle) -> None:
        """Replace the first K element x of a sealed bundle by -x + 1 in the
        bundle's own dtype (the reference's flip): a silent change that
        only the checksum can see.  The payload is copied first, never
        changed under another holder."""
        k = np.array(bundle.k)
        x = torch.from_numpy(k.reshape(-1)[:1].copy())
        if bundle.dtype in ("bfloat16", "float16"):
            dt = getattr(torch, bundle.dtype)
            y = -x.view(dt) + torch.ones(1, dtype=dt)
            k.reshape(-1)[0] = y.view(torch.int16).numpy().view(k.dtype)[0]
        else:
            k.reshape(-1)[0] = (-x + torch.ones(1, dtype=x.dtype)).numpy()[0]
        bundle.k = k


__all__ = ["FaultPlan", "FaultInjector", "FAULT_KINDS", "hash_unit"]
