"""Parallel execution context: the port's own copy of
``repro/core/pcontext.py``.

``ParallelCtx`` carries the mesh-axis wiring of a step.  All model code
takes a ctx (and, for tp > 1, a :class:`repro_torch.core.mesh.VirtualMesh`)
and calls the collectives in :mod:`repro_torch.core.hierarchical`; with an
empty ctx (no axes) every collective is the identity, so the same model
code runs at tp=1 and over the virtual mesh.  The dataclass accepts every
knob of the reference.  ``seq_parallel`` is a knob of the model's prefill
(``transformer.forward_lm`` resolves it per call); the collectives ignore
it, as in the reference.  ``transformer.check_layout`` raises on a
non-empty ``dp``, ``fsdp`` or ``sp`` for serving (the virtual mesh holds
the TP axes only); the train step
(``parallel/steps.py::build_train_step``) has its own check, which takes
``dp`` over the slow axis of a ``VirtualMesh(pods, 1)`` and the
reference's training ctx of :func:`single_pod_ctx` at one rank, and reads
``grad_reduce_strategy`` (the cross-pod gradient sum of
``hierarchical.grad_cross_pod_reduce``).  ``ar_strategy="auto"``
resolves per call against :mod:`repro_torch.core.autotune`, and
``overlap_matmul`` routes the
row-parallel projections through :mod:`repro_torch.core.overlap` in
``overlap_chunks`` column blocks; ``ar_quant`` (and the legacy
``compress_slow`` / ``quant_ag``) puts the collectives on the quantized
wire.

Axis roles
----------
- ``tp_fast``: tensor-parallel axes on the fast interconnect (ICI).  The
  paper's "intra-node" level.
- ``tp_slow``: tensor-parallel axes on the slow interconnect (DCN).  The
  paper's "inter-node" level; non-empty only for cross-pod TP deployments.
- ``dp``:     pure batch-parallel axes (gradients reduced across them).
- ``fsdp``:   weight-sharding axes; weights are all-gathered per layer on the
  forward pass (ZeRO-3 style), which AD transposes into gradient
  reduce-scatters.
- ``ep``:     expert-parallel axes for MoE layers: empty, or the TP axes
  themselves (slow-major), since the experts are sharded over every TP
  axis (``VirtualMesh.check_ctx`` refuses any other set).
- ``sp``:     sequence-parallel axes (activations sequence-sharded between
  blocks; usually == tp_fast).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

AxisNames = Tuple[str, ...]

AR_STRATEGIES = ("flat", "hier_ring", "hier_rd", "hier_rd_halving", "auto")

SEQ_PARALLEL_MODES = ("off", "on", "auto")

GRAD_REDUCE_STRATEGIES = ("flat", "rd", "rd_int8")

# Quantized-collective levels for the TP all-reduce / RS+AG family.
# "none" keeps full-precision wire; "int8"/"int4" force that level at every
# call site; "auto" lets the autotuner pick {none, int8, int4} per call site
# (requires ar_strategy="auto" so the same trace-time dispatch hook fires).
AR_QUANT_LEVELS = ("none", "int8", "int4")
AR_QUANT_MODES = AR_QUANT_LEVELS + ("auto",)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_fast: AxisNames = ()
    tp_slow: AxisNames = ()
    dp: AxisNames = ()
    fsdp: AxisNames = ()
    ep: AxisNames = ()
    sp: AxisNames = ()
    # All-reduce strategy for TP partial sums (the paper's subject):
    #   flat             - single XLA all-reduce over all TP axes (NCCL baseline)
    #   hier_ring        - RS(fast) + psum(slow, XLA ring) + AG(fast)
    #   hier_rd          - RS(fast) + recursive doubling(slow) + AG(fast)  [NVRAR]
    #   hier_rd_halving  - RS(fast) + recursive halving/doubling(slow) + AG(fast)
    #   auto             - per-call dispatch on (message bytes, topology,
    #                      dtype) via repro_torch.core.autotune, resolved
    #                      on the host at every call
    ar_strategy: str = "flat"
    # Cross-pod gradient reduction (training): flat | rd | rd_int8.
    grad_reduce_strategy: str = "rd"
    # Chunk count for pipelined slow-axis exchanges (paper Sec. 4.2.1 analogue).
    rd_chunks: int = 1
    # int8-compress the slow-axis TP exchange (beyond-paper; eta-packing).
    compress_slow: bool = False
    # Quantized all-gather: TP AR runs as RS(bf16) + AG(int8 + scales) —
    # cuts fast-axis AR wire bytes ~25-45% (beyond-paper optimization).
    # Legacy force-knob; superseded by ``ar_quant`` which quantizes every
    # phase and is autotuner-dispatchable.
    quant_ag: bool = False
    # Quantized collective level for tp_all_reduce / tp_reduce_scatter /
    # tp_all_gather: "none" | "int8" | "int4" | "auto".  int8/int4 carry
    # nibble/byte-packed payloads + per-group bf16 scales on the wire
    # (Flash-Communication-style low-bit comm); "auto" lets the AutoTuner
    # pick {none, int8, int4} per call site alongside the strategy (needs
    # ar_strategy="auto").  Error feedback for the lossy levels rides in
    # the decode cache (see DESIGN.md §12).
    ar_quant: str = "none"
    # Overlapped collective-matmul: route row-parallel output projections
    # (attention wo / MLP down-proj) through repro_torch.core.overlap so
    # chunk q's all-reduce pipelines against chunk q+1's GEMM (under
    # hier_rd: inside the fused GEMM + recursive-doubling kernel).
    overlap_matmul: bool = False
    # Column blocks of the overlapped projections (rounded down to a count
    # that divides the output features; see overlap._resolve_chunks).
    overlap_chunks: int = 4
    # Sequence-parallel prefill (Megatron-SP residual layout): the residual
    # stream stays sequence-sharded over tp_fast between sublayers — the
    # row-parallel projections (attention wo / MLP down) end in
    # tp_reduce_scatter on the sequence dim, norms run on sequence shards,
    # and tp_all_gather restores full sequence only where QKV / up-proj
    # need it.  "off" keeps the fused per-residual all-reduce, "on" forces
    # the RS+AG decomposition wherever the sequence divides tp_fast, and
    # "auto" dispatches per call site on message size via the autotuner's
    # SP table (decode steps never decompose — their one-token messages
    # live in the latency-bound regime; see DESIGN.md §10).
    seq_parallel: str = "off"

    def __post_init__(self):
        if self.ar_strategy not in AR_STRATEGIES:
            raise ValueError(f"unknown ar_strategy {self.ar_strategy!r}")
        if self.grad_reduce_strategy not in GRAD_REDUCE_STRATEGIES:
            raise ValueError(f"unknown grad_reduce_strategy "
                             f"{self.grad_reduce_strategy!r}")
        if self.seq_parallel not in SEQ_PARALLEL_MODES:
            raise ValueError(
                f"unknown seq_parallel mode {self.seq_parallel!r}")
        if self.ar_quant not in AR_QUANT_MODES:
            raise ValueError(f"unknown ar_quant mode {self.ar_quant!r}")
        if self.ar_quant == "auto" and self.ar_strategy != "auto":
            raise ValueError(
                "ar_quant='auto' requires ar_strategy='auto' (quant level "
                "is picked by the same trace-time autotune dispatch); got "
                f"ar_strategy={self.ar_strategy!r}")

    # -- derived -----------------------------------------------------------
    @property
    def tp_axes(self) -> AxisNames:
        return self.tp_slow + self.tp_fast

    @property
    def has_tp(self) -> bool:
        return bool(self.tp_axes)

    def replace(self, **kw) -> "ParallelCtx":
        return dataclasses.replace(self, **kw)


# A fully-local context: every collective is the identity.
LOCAL = ParallelCtx()


def single_pod_ctx(ar_strategy: str = "flat", **kw) -> ParallelCtx:
    """The reference's wiring of a ("data", "model") mesh: FSDP and data
    parallelism over "data", TP, EP and SP over "model".  The port's
    train step takes it at one rank (every axis of size 1)."""
    return ParallelCtx(tp_fast=("model",), dp=("data",), fsdp=("data",),
                       ep=("model",), sp=("model",), ar_strategy=ar_strategy,
                       **kw)


def multi_pod_ctx(ar_strategy: str = "flat", cross_pod_tp: bool = False,
                  **kw) -> ParallelCtx:
    """The reference's wiring of a ("pod", "data", "model") mesh: with
    ``cross_pod_tp`` the TP group spans the pods (the paper's headline
    scenario), else the pods are a data-parallel axis whose gradients are
    summed by ``grad_cross_pod_reduce``."""
    if cross_pod_tp:
        return ParallelCtx(tp_fast=("model",), tp_slow=("pod",),
                           dp=("data",), fsdp=("data",), ep=("model",),
                           sp=("model",), ar_strategy=ar_strategy, **kw)
    return ParallelCtx(tp_fast=("model",), dp=("pod", "data"),
                       fsdp=("data",), ep=("model",), sp=("model",),
                       ar_strategy=ar_strategy, **kw)


__all__ = ["ParallelCtx", "LOCAL", "single_pod_ctx", "multi_pod_ctx",
           "AR_STRATEGIES", "SEQ_PARALLEL_MODES", "GRAD_REDUCE_STRATEGIES",
           "AR_QUANT_LEVELS", "AR_QUANT_MODES"]
