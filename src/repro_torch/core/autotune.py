"""Message-size-aware all-reduce strategy autotuner: the port's own copy of
``repro/core/autotune.py`` (the full-precision dispatch behind
``ar_strategy="auto"``).

The paper's finding (Sec. 4.3/5) is that the best all-reduce algorithm is
a function of message size and topology: recursive doubling (NVRAR) wins
in the latency-bound regime, ring-style algorithms once the transfer is
bandwidth-bound.  This module gives:

* a **dispatch table** keyed on (message-byte bucket, fast-axis size,
  slow-axis size, dtype name) mapping to an :class:`ARChoice`;
* **analytic seeding** from the alpha-beta models of
  :mod:`repro_torch.core.comm_model`;
* **measurement refinement** (:meth:`AutoTuner.record`,
  :meth:`AutoTuner.refine`);
* **JSON persistence** in the reference's schema, with the reference's
  dtype names (``"bfloat16"``, ``"float32"``) in the keys, so a table
  saved by one package loads in the other with the same choices.

Two departures from the reference.  The default network is
``PERLMUTTER`` (4 GPUs a node over Slingshot: the paper's machine and the
shape of the port's ``pods x fast`` mesh) where the reference defaults to
``TPU_V5E``.  And the reference resolves ``auto`` once per call site at
trace time, while eager PyTorch has no trace: the port resolves at every
call, on the host (a lock, a key and a dict lookup).  The sequence-
parallel table is persisted but not consulted (ROADMAP item 9).

Quantized dispatch (the ctx's ``ar_quant`` policy other than ``"none"``)
keys its own namespace (dtype suffix ``:q<policy>``) and seeds from
:func:`analytic_quant_choice`: a forced level always quantizes, ``auto``
climbs the none -> int8 -> int4 ladder on the predicted times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import threading
import warnings
from typing import Dict, List, Optional, Tuple, Union

from . import comm_model as cm

# Strategies the dispatcher may pick from (ParallelCtx.ar_strategy values).
DISPATCHABLE = ("flat", "hier_ring", "hier_rd", "hier_rd_halving")

# Wire-quantization levels a table entry may carry (ParallelCtx.ar_quant
# values minus "auto").
QUANT_LEVELS = ("none", "int8", "int4")

# Persisted-table schema version (``to_json``), the reference's.
TABLE_VERSION = 1

# Chunked slow-axis exchange kicks in once the per-step inter payload
# crosses this size (paper Sec. 4.2.1), capped at _MAX_RD_CHUNKS.
_CHUNK_THRESHOLD_BYTES = 256 * 1024
_MAX_RD_CHUNKS = 8

DEFAULT_NET = cm.PERLMUTTER


@dataclasses.dataclass(frozen=True)
class ARChoice:
    """One dispatch-table entry: a fully resolved all-reduce configuration."""

    strategy: str                 # one of DISPATCHABLE
    rd_chunks: int = 1            # slow-axis pipeline chunks (hier_rd only)
    compress_slow: bool = False   # int8-compress the slow exchange (lossy)
    quant: str = "none"           # wire quantization level (QUANT_LEVELS)

    def apply(self, ctx):
        """Concretize a ctx whose ar_strategy is 'auto' with this choice
        (``quant`` is written back only under ``ar_quant="auto"``; one
        ``replace`` so the validator never sees a half-resolved ctx)."""
        kw = dict(ar_strategy=self.strategy, rd_chunks=self.rd_chunks,
                  compress_slow=self.compress_slow)
        if getattr(ctx, "ar_quant", "none") == "auto":
            kw["ar_quant"] = self.quant
        return ctx.replace(**kw)


# ---------------------------------------------------------------------------
# Analytic model: predicted time per strategy
# ---------------------------------------------------------------------------


def predict_times(msg_bytes: float, fast_size: int, slow_size: int,
                  net: cm.NetworkSpec) -> Dict[str, float]:
    """Predicted all-reduce seconds per strategy on ``net``, with the fast
    axis as the paper's G GPUs a node and the slow axis as its N nodes:
    ``flat`` is the single-level ring (Eq. 1); the hierarchical strategies
    share the RS/AG intra phases (Eqs. 3/5) and differ in the inter phase
    (ring, full-exchange recursive doubling, halving/doubling)."""
    g, n = max(1, fast_size), max(1, slow_size)
    if n <= 1:
        t = 2.0 * cm.t_reduce_scatter_intra(msg_bytes, g, net)
        return {s: t for s in DISPATCHABLE}
    intra = (cm.t_reduce_scatter_intra(msg_bytes, g, net)
             + cm.t_allgather_intra(msg_bytes, g, net))
    shard = msg_bytes / g  # slow phase operates on the RS-scattered shard
    ring_inter = 2.0 * (n - 1) * net.alpha_inter \
        + 2.0 * (n - 1) / n * (shard / net.beta_inter)
    rd_inter = cm.t_rd_inter_full_exchange(msg_bytes, n, g, net)
    halving_inter = cm.t_rd_halving_inter(msg_bytes, n, g, net)
    return {
        "flat": cm.t_ring_allreduce(msg_bytes, n, g, net),
        "hier_ring": intra + ring_inter,
        "hier_rd": intra + rd_inter,
        "hier_rd_halving": intra + halving_inter,
    }


def _rd_chunks_for(msg_bytes: float, fast_size: int) -> int:
    """Pipeline chunk count for the hier_rd slow exchange (Sec. 4.2.1):
    one chunk per _CHUNK_THRESHOLD_BYTES of the RS-scattered shard."""
    shard = msg_bytes / max(1, fast_size)
    return int(min(_MAX_RD_CHUNKS,
                   max(1, shard // _CHUNK_THRESHOLD_BYTES)))


def analytic_choice(msg_bytes: float, fast_size: int, slow_size: int,
                    net: cm.NetworkSpec, *,
                    allow_lossy: bool = False) -> ARChoice:
    """Best strategy under the alpha-beta model; ties break toward the
    fewest inter-phase latency steps."""
    times = predict_times(msg_bytes, fast_size, slow_size, net)
    order = ("hier_rd", "hier_rd_halving", "hier_ring", "flat")
    best = min(order, key=lambda s: times[s])
    rd_chunks = 1
    if best == "hier_rd" and slow_size > 1:
        rd_chunks = _rd_chunks_for(msg_bytes, fast_size)
    compress = False
    if allow_lossy and slow_size > 1:
        shard = msg_bytes / max(1, fast_size)
        bw_term = (slow_size - 1) / slow_size * shard / net.beta_inter
        lat_term = math.log2(max(2, slow_size)) * net.alpha_inter
        compress = bw_term > 4.0 * lat_term
    return ARChoice(strategy=best, rd_chunks=rd_chunks,
                    compress_slow=compress)


def predict_quant_times(msg_bytes: float, fast_size: int, slow_size: int,
                        net: cm.NetworkSpec) -> Dict[str, float]:
    """Predicted seconds per wire-quantization level: ``none`` is the
    best full-precision strategy at this size, int8/int4 the quantized
    hierarchical path, whose bandwidth terms shrink by the wire factor
    while its latency terms and per-phase pack overhead do not."""
    t_none = min(predict_times(msg_bytes, fast_size, slow_size, net)
                 .values())
    return {
        "none": t_none,
        "int8": cm.t_quant_hier_allreduce(msg_bytes, slow_size, fast_size,
                                          net, 8),
        "int4": cm.t_quant_hier_allreduce(msg_bytes, slow_size, fast_size,
                                          net, 4),
    }


def analytic_quant_choice(msg_bytes: float, fast_size: int, slow_size: int,
                          net: cm.NetworkSpec, mode: str) -> ARChoice:
    """Dispatch entry for a quant-aware call site (``mode`` != "none").
    Forced modes always quantize, through hier_rd when a slow axis
    exists; ``"auto"`` takes a lossier level only where it beats the
    previous one by more than 10% predicted time."""
    base = analytic_choice(msg_bytes, fast_size, slow_size, net)
    if mode in ("int8", "int4"):
        strat = "hier_rd" if slow_size > 1 else base.strategy
        return ARChoice(strategy=strat, rd_chunks=1, quant=mode)
    t = predict_quant_times(msg_bytes, fast_size, slow_size, net)
    quant = "none"
    if t["int8"] < 0.9 * t["none"]:
        quant = "int8"
        if t["int4"] < 0.9 * t["int8"]:
            quant = "int4"
    if quant == "none":
        return base
    strat = "hier_rd" if slow_size > 1 else base.strategy
    return ARChoice(strategy=strat, rd_chunks=1, quant=quant)


# ---------------------------------------------------------------------------
# Dispatch table
# ---------------------------------------------------------------------------


def _bucket(msg_bytes: int) -> int:
    """Power-of-two message-size bucket (log2, clamped)."""
    return max(8, int(math.ceil(math.log2(max(1, int(msg_bytes))))))


def bucket_of(msg_bytes: int) -> int:
    """Public form of the table's message-size bucketing (log2 exponent)."""
    return _bucket(msg_bytes)


def _key(msg_bytes: int, fast_size: int, slow_size: int,
         dtype: str) -> str:
    return f"b{_bucket(msg_bytes)}/f{fast_size}/s{slow_size}/{dtype}"


def _parse_key(key: str) -> Tuple[int, int, int, str]:
    """(bucket_bytes, fast_size, slow_size, dtype) back out of a table key;
    ``bucket_bytes`` is the bucket's bound ``2**b``."""
    b, f, s, dtype = key.split("/")
    return 2 ** int(b[1:]), int(f[1:]), int(s[1:]), dtype


@dataclasses.dataclass
class _Measurement:
    strategy: str
    seconds: float
    quant: str = "none"


class AutoTuner:
    """Per-call-site all-reduce dispatcher: analytic predictions seed every
    lookup; measurements override them after :meth:`refine`."""

    def __init__(self, net: cm.NetworkSpec = DEFAULT_NET, *,
                 allow_lossy: bool = False):
        self.net = net
        self.allow_lossy = allow_lossy
        self.table: Dict[str, ARChoice] = {}
        self.measurements: Dict[str, List[_Measurement]] = {}
        self.lookups: Dict[str, int] = {}       # key -> times dispatched
        self.sp_table: Dict[str, bool] = {}     # persisted, not consulted
        self._lock = threading.Lock()

    def choose(self, msg_bytes: int, fast_size: int, slow_size: int,
               dtype: str = "bfloat16", quant: str = "none") -> ARChoice:
        """Dispatch one call site; ``dtype`` is the reference's dtype name
        (``"bfloat16"``, ``"float32"``) and ``quant`` the ctx's ar_quant
        policy: "none" keys plain dispatch, any other policy its own
        namespace (``bfloat16:qauto``), so the two never alias a bucket."""
        kdtype = dtype if quant == "none" else f"{dtype}:q{quant}"
        key = _key(msg_bytes, fast_size, slow_size, kdtype)
        with self._lock:
            self.lookups[key] = self.lookups.get(key, 0) + 1
            hit = self.table.get(key)
            if hit is None:
                if quant == "none":
                    hit = analytic_choice(msg_bytes, fast_size, slow_size,
                                          self.net,
                                          allow_lossy=self.allow_lossy)
                else:
                    hit = analytic_quant_choice(msg_bytes, fast_size,
                                                slow_size, self.net, quant)
                self.table[key] = hit
            return hit

    # -- measurement refinement -------------------------------------------

    def record(self, msg_bytes: int, fast_size: int, slow_size: int,
               dtype: str, strategy: str, seconds: float,
               quant: str = "none",
               policy: Optional[str] = None) -> None:
        """File one measured (strategy, quant) latency under the dispatch
        namespace ``policy`` (default: ``quant``)."""
        ns = quant if policy is None else policy
        kdtype = dtype if ns == "none" else f"{dtype}:q{ns}"
        key = _key(msg_bytes, fast_size, slow_size, kdtype)
        with self._lock:
            self.measurements.setdefault(key, []).append(
                _Measurement(strategy, seconds, quant))

    def refine(self) -> int:
        """Overwrite table entries with measured winners; returns the number
        of entries changed.  An unquantized hier_rd winner chunks on the
        bucket bound; quantized winners keep rd_chunks=1 (the quantized
        slow exchange requantizes every step and is not chunked)."""
        changed = 0
        with self._lock:
            for key, ms in self.measurements.items():
                best = min(ms, key=lambda m: m.seconds)
                prev = self.table.get(key)
                rd_chunks = 1
                if best.strategy == "hier_rd" and best.quant == "none":
                    bucket_bytes, fast, slow, _ = _parse_key(key)
                    if slow > 1:
                        rd_chunks = _rd_chunks_for(bucket_bytes, fast)
                new = ARChoice(strategy=best.strategy, rd_chunks=rd_chunks,
                               compress_slow=prev.compress_slow
                               if prev else False,
                               quant=best.quant)
                if prev != new:
                    self.table[key] = new
                    changed += 1
        return changed

    # -- persistence -------------------------------------------------------

    def to_json(self) -> Dict:
        return {
            "version": TABLE_VERSION,
            "net": self.net.name,
            "allow_lossy": self.allow_lossy,
            "table": {k: dataclasses.asdict(v)
                      for k, v in sorted(self.table.items())},
            "sp_table": dict(sorted(self.sp_table.items())),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def _degraded(cls, path: str, why: str) -> "AutoTuner":
        """An unusable table: warn and seed a fresh analytic tuner."""
        warnings.warn(f"ar-table {path!r} unusable ({why}); degrading to "
                      f"analytic comm-model seeding", RuntimeWarning,
                      stacklevel=3)
        return cls()

    @classmethod
    def load(cls, path: str) -> "AutoTuner":
        """Load a persisted table (either package's), degrading (never
        raising) on a corrupt or wrong-schema file; malformed entries are
        dropped and counted in a warning."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            return cls._degraded(path, f"unreadable: {e}")
        if isinstance(doc, dict) and "tuned_table" in doc \
                and "table" not in doc:
            doc = doc["tuned_table"]       # a bench sweep artifact
        if not isinstance(doc, dict):
            return cls._degraded(path, f"JSON {type(doc).__name__}, "
                                       f"not an object")
        version = doc.get("version", 1)
        if version != TABLE_VERSION:
            return cls._degraded(path, f"schema version {version!r} != "
                                       f"{TABLE_VERSION}")
        net = cm.NETWORKS.get(doc.get("net", DEFAULT_NET.name), DEFAULT_NET)
        t = cls(net, allow_lossy=bool(doc.get("allow_lossy", False)))
        table = doc.get("table", {})
        sp_table = doc.get("sp_table", {})
        if not isinstance(table, dict) or not isinstance(sp_table, dict):
            return cls._degraded(path, "table/sp_table not objects")
        dropped = 0
        for k, v in table.items():
            try:
                _parse_key(k)
                c = ARChoice(**v)
                if c.strategy not in DISPATCHABLE:
                    raise ValueError(f"unknown strategy {c.strategy!r}")
                if int(c.rd_chunks) < 1:
                    raise ValueError(f"rd_chunks {c.rd_chunks!r} < 1")
                if c.quant not in QUANT_LEVELS:
                    raise ValueError(f"unknown quant {c.quant!r}")
            except (TypeError, ValueError, AttributeError, IndexError):
                dropped += 1
                continue
            t.table[k] = c
        for k, v in sp_table.items():
            try:
                int(str(k).split("/")[0][1:])
            except (TypeError, ValueError, IndexError):
                dropped += 1
                continue
            t.sp_table[k] = bool(v)
        if dropped:
            warnings.warn(f"ar-table {path!r}: dropped {dropped} "
                          f"malformed entr{'y' if dropped == 1 else 'ies'}"
                          f"; kept {len(t.table) + len(t.sp_table)}",
                          RuntimeWarning, stacklevel=2)
        return t


# ---------------------------------------------------------------------------
# Process-wide active tuner (what ar_strategy="auto" resolves against)
# ---------------------------------------------------------------------------

_ACTIVE = AutoTuner()


def active() -> AutoTuner:
    return _ACTIVE


def install(tuner: AutoTuner) -> AutoTuner:
    """Swap the process-wide tuner (returns the previous one)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tuner
    return prev


def tuner_for(path: Optional[Union[str, AutoTuner]]) -> AutoTuner:
    """The tuner a step builder captures: an :class:`AutoTuner` passes
    through, an existing path loads, else ``REPRO_AR_TABLE`` (as in the
    reference), else the active default."""
    if isinstance(path, AutoTuner):
        return path
    if path is None:
        path = os.environ.get("REPRO_AR_TABLE")
    if path and os.path.exists(path):
        return AutoTuner.load(path)
    return _ACTIVE


@contextlib.contextmanager
def using(tuner: AutoTuner):
    """Make ``tuner`` the active dispatcher for the duration of a step."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tuner
    try:
        yield tuner
    finally:
        _ACTIVE = prev


@functools.lru_cache(maxsize=1024)
def _applied(choice: ARChoice, ctx):
    """``choice.apply(ctx)``, memoised: both are frozen and hashed whole
    (the choice's ``quant``, which ``apply`` writes back under
    ``ar_quant="auto"``, included), and rebuilding the ctx
    (``dataclasses.replace``) was most of a resolution's host time."""
    return choice.apply(ctx)


def resolve(ctx, msg_bytes: int, fast_size: int, slow_size: int,
            dtype: str):
    """Concretize ctx.ar_strategy == 'auto' for one call against the
    active tuner."""
    choice = _ACTIVE.choose(int(msg_bytes), fast_size, slow_size,
                            str(dtype),
                            quant=getattr(ctx, "ar_quant", "none"))
    return _applied(choice, ctx)


__all__ = [
    "ARChoice", "AutoTuner", "predict_times", "analytic_choice",
    "predict_quant_times", "analytic_quant_choice", "QUANT_LEVELS",
    "DEFAULT_NET", "active", "install", "tuner_for", "using", "resolve",
    "bucket_of", "DISPATCHABLE", "TABLE_VERSION",
]
