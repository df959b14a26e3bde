"""Mesh construction and replica carving: the port of
``repro/parallel/topology.py``.

:func:`mesh_and_ctx` turns a requested layout (tp ways, the pod split, the
all-reduce knobs) into ``(mesh, ctx, tp)``; each call makes a new
:class:`~repro_torch.core.mesh.VirtualMesh`, so each serving replica and
each disaggregated pool owns its mesh and its exchange workspace (a
prefill on one pool never moves another pool's
``RDWorkspace.generation``).

On one card every replica is its own virtual mesh on the same device.  The
reference carves ``jax.devices()`` into disjoint contiguous groups and
refuses a fleet that needs more devices than are visible; the port has no
counterpart of that refusal (ROADMAP §3): any number of replicas shares the
one device, and :func:`replica_device_groups` gives each the device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core.mesh import VirtualMesh, mesh_and_ctx as _mesh_and_ctx
from ..core.pcontext import ParallelCtx


def mesh_and_ctx(tp: int, pods: int = 1, *, ar_strategy: str = "flat",
                 overlap: bool = False, overlap_chunks: int = 4,
                 seq_parallel: str = "off", ar_quant: str = "none",
                 device: torch.device | str = "cuda"
                 ) -> Tuple[Optional[VirtualMesh], ParallelCtx, int]:
    """(mesh, ctx, tp_total) for the layout: no mesh and the local ctx at
    tp == 1, else a new (pods, tp/pods) virtual mesh on ``device`` with
    the ctx that wires it, and the knobs set (``seq_parallel`` shapes the
    prefill: ``transformer.forward_lm`` resolves it per call)."""
    mesh, ctx = _mesh_and_ctx(tp, pods, ar_strategy=ar_strategy,
                              device=device)
    ctx = ctx.replace(overlap_matmul=overlap, overlap_chunks=overlap_chunks,
                      seq_parallel=seq_parallel, ar_quant=ar_quant)
    return mesh, ctx, max(tp, 1)


def replica_device_groups(n_replicas: int, tp: int,
                          device: torch.device | str = "cuda"
                          ) -> List[torch.device]:
    """The device of each of ``n_replicas`` replicas of ``tp`` ranks: the
    one card, for all of them (each builds its own virtual mesh there)."""
    if n_replicas < 1:
        raise ValueError(f"need n_replicas >= 1, got {n_replicas}")
    if tp < 1:
        raise ValueError(f"need tp >= 1, got {tp}")
    return [torch.device(device)] * n_replicas


__all__ = ["mesh_and_ctx", "replica_device_groups"]
