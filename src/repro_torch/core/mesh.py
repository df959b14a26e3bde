"""The virtual mesh: a tensor-parallel group of ``pods x fast`` ranks on
one device, the port's counterpart of ``repro/core/compat.py::make_mesh``
and ``shard_map`` (and of ``parallel/topology.py::mesh_and_ctx``).

Where JAX runs a step once per device under ``shard_map``, the port runs it
once for all ranks: every per-device tensor carries a leading rank axis of
size R = pods * fast, ordered slow-major (rank = pod * fast + f), the
order in which ``PartitionSpec((slow, fast))`` slices a dimension and in
which ``layers.tp_rank`` linearises the axes.  It is the picture that
``jax.vmap(..., axis_name=...)`` makes of the reference's SPMD code, and
the collectives of :mod:`repro_torch.core.hierarchical` act across that
axis.

The mesh also owns the persistent workspace of its exchange kernels (the
recursive-doubling all-reduce and the fused GEMM + recursive doubling:
receive buffers and flags, the analogue of NVSHMEM's symmetric heap, and
the sequence counter both draw from).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rd_allreduce import RDWorkspace
from .pcontext import LOCAL, ParallelCtx


class VirtualMesh:
    """``pods`` ranks on the slow axis times ``fast`` on the fast axis,
    all on ``device``."""

    def __init__(self, pods: int, fast: int, *,
                 device: torch.device | str = "cuda",
                 slow_axis: str = "pod", fast_axis: str = "model"):
        if pods < 1 or fast < 1:
            raise ValueError(f"mesh ({pods}, {fast}): sizes must be >= 1")
        self.pods, self.fast = pods, fast
        self.slow_axis, self.fast_axis = slow_axis, fast_axis
        self.device = torch.device(device)
        self.workspace = RDWorkspace()

    @property
    def size(self) -> int:
        return self.pods * self.fast

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (self.slow_axis, self.fast_axis)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.pods, self.fast)

    def axis_size(self, name: str) -> int:
        if name == self.slow_axis:
            return self.pods
        if name == self.fast_axis:
            return self.fast
        raise KeyError(f"axis {name!r} is not one of {self.axis_names}")

    def rank(self, pod: int, f: int) -> int:
        return pod * self.fast + f

    def coords(self, rank: int) -> Tuple[int, int]:
        return divmod(rank, self.fast)

    def check_ctx(self, ctx: ParallelCtx) -> None:
        """Raise unless ``ctx`` wires this mesh: at most one slow and one
        fast TP axis, named as the mesh's, every axis of size > 1 among
        them (else the collectives would skip ranks), and an expert axis
        set ``ep`` that is empty or the TP axes themselves."""
        if len(ctx.tp_slow) > 1 or len(ctx.tp_fast) > 1:
            raise NotImplementedError(
                f"ctx {ctx.tp_slow}/{ctx.tp_fast}: the virtual mesh has one "
                "slow and one fast axis")
        if ctx.tp_slow not in ((), (self.slow_axis,)) \
                or ctx.tp_fast not in ((), (self.fast_axis,)):
            raise ValueError(f"ctx axes {ctx.tp_slow}/{ctx.tp_fast} are not "
                             f"the mesh's {self.axis_names}")
        for name, n in zip(self.axis_names, self.shape):
            if n > 1 and name not in ctx.tp_axes:
                raise ValueError(f"mesh axis {name!r} (size {n}) is not a "
                                 f"TP axis of ctx {ctx.tp_axes}")
        if ctx.ep and ctx.ep != ctx.tp_axes:
            # The reference cuts the expert leaves over every TP axis
            # (parallel/sharding.py::_tp_dim) but takes E_loc and the
            # expert offset from ``ep`` alone (models/moe.py), so an ``ep``
            # narrower than the TP axes (its multi_pod_ctx(cross_pod_tp=
            # True) wiring, ep=("model",) with pods) gives tp=N tokens that
            # differ from tp=1's (ROADMAP §3).
            raise ValueError(f"ctx ep={ctx.ep} is not the TP axes "
                             f"{ctx.tp_axes}: expert parallelism must span "
                             "the axes the experts are sharded over")

    def __repr__(self) -> str:
        return (f"VirtualMesh(pods={self.pods}, fast={self.fast}, "
                f"device={self.device})")


def mesh_and_ctx(tp: int, pods: int = 1, *, ar_strategy: str = "flat",
                 device: torch.device | str = "cuda"
                 ) -> Tuple[Optional[VirtualMesh], ParallelCtx]:
    """(mesh, ctx) for a requested layout, as the reference's
    ``topology.mesh_and_ctx``: no mesh and the local ctx at tp == 1; a
    (pods, tp/pods) mesh with ``tp_slow=("pod",)`` when pods > 1.  The
    experts are parallel over the TP axes, slow-major (``ep`` =
    ``("pod", "model")`` with pods, ``("model",)`` without), not over the
    fast axis alone as the reference's cross-pod wiring has it."""
    ctx = LOCAL.replace(ar_strategy=ar_strategy)
    if tp <= 1:
        return None, ctx
    if tp % pods:
        raise ValueError(f"tp={tp} not divisible by pods={pods}")
    mesh = VirtualMesh(pods, tp // pods, device=device)
    if pods > 1:
        ctx = ctx.replace(tp_fast=("model",), tp_slow=("pod",),
                          ep=("pod", "model"))
    else:
        ctx = ctx.replace(tp_fast=("model",), ep=("model",))
    return mesh, ctx


__all__ = ["VirtualMesh", "mesh_and_ctx"]
