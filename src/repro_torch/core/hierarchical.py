"""Hierarchical all-reduce strategies over the virtual mesh: the port of
the full-precision wire of ``repro/core/hierarchical.py``.

Every tensor here carries the ranks of a :class:`~repro_torch.core.mesh.
VirtualMesh` on its leading axis (rank = pod * fast + f), so a collective
is an operation across that axis; ``dim`` and ``scatter_dim`` count the
dimensions of one rank's tensor, as in the reference.  With a ctx that
has no TP axes every collective is the identity.

====================  =======================================================
flat                  one sum over all ranks (the library all-reduce)
hier_ring             RS(fast) + sum over the pods + AG(fast)
hier_rd               RS(fast) + recursive doubling over the pods in the
                      hand-written CUDA kernel + AG(fast)  [NVRAR]
hier_rd_halving       RS(fast) + recursive halving/doubling(slow) + AG(fast),
                      plain torch (the reference has no kernel for it)
====================  =======================================================

``auto`` resolves per call to one of these from one rank's message bytes,
the fast and slow sizes and the dtype name, through
:func:`repro_torch.core.autotune.resolve` (``_resolve_auto``).  The
quantized wire (``ar_quant``, ``compress_slow``, ``quant_ag``) and the
sequence-parallel layout are not ported yet: a ctx asking for one raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..kernels import rd_allreduce as rdk
from ..kernels.rd_allreduce.ref import is_pow2 as _is_pow2
from ..kernels.rd_allreduce.ref import slow_sum
from . import autotune
from .mesh import VirtualMesh
from .pcontext import ParallelCtx

Mesh = Optional[VirtualMesh]


def _unported(ctx: ParallelCtx) -> None:
    """Raise on the knobs whose collectives arrive in a later slice."""
    if ctx.ar_quant != "none" or ctx.compress_slow or ctx.quant_ag:
        raise NotImplementedError("the quantized wire (ar_quant, "
                                  "compress_slow, quant_ag) arrives with "
                                  "ROADMAP item 9")
    if ctx.seq_parallel != "off":
        raise NotImplementedError("seq_parallel (sequence-parallel "
                                  "residuals) arrives with ROADMAP item 9")


def axes_size(axes: Sequence[str], mesh: Mesh) -> int:
    """Product of the mesh sizes of ``axes``."""
    n = 1
    for a in axes:
        n *= mesh.axis_size(a)
    return n


@functools.lru_cache(maxsize=None)
def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a dtype (``"bfloat16"``, ``"float32"``),
    as the autotuner's table keys spell it."""
    return str(dtype).removeprefix("torch.")


def _sizes(ctx: ParallelCtx, mesh: Mesh):
    """(pods, fast) as the ctx sees the mesh: an axis the ctx leaves out
    counts 1 (``VirtualMesh.check_ctx`` makes sure it has size 1)."""
    return (axes_size(ctx.tp_slow, mesh) if ctx.tp_slow else 1,
            axes_size(ctx.tp_fast, mesh) if ctx.tp_fast else 1)


def tp_rank(ctx: ParallelCtx, mesh: Mesh, device=None) -> torch.Tensor:
    """Every rank's linear index in the TP group (slow axes outermost),
    (R,) int64: ``layers.tp_rank`` for all ranks at once."""
    pods, fast = _sizes(ctx, mesh) if ctx.has_tp else (1, 1)
    return torch.arange(pods * fast, device=device)


def _resolve_auto(x: torch.Tensor, ctx: ParallelCtx,
                  mesh: Mesh) -> ParallelCtx:
    """Concretize ``ar_strategy="auto"`` for this call from one rank's
    message (x is (R, ...)), as the reference resolves each call site at
    trace time; here it runs on the host at every call."""
    if ctx.ar_strategy != "auto":
        return ctx
    pods, fast = _sizes(ctx, mesh)
    return autotune.resolve(ctx, x.numel() // x.shape[0] * x.element_size(),
                            fast, pods, dtype_name(x.dtype))


# ---------------------------------------------------------------------------
# Slow-axis all-reduces
# ---------------------------------------------------------------------------


def rd_all_reduce(x: torch.Tensor, mesh: VirtualMesh,
                  chunks: int = 1) -> torch.Tensor:
    """Recursive-doubling all-reduce over the slow axis (Algorithm 1's
    ``RD_inter``): the hand-written kernel on CUDA tensors, its plain
    version on CPU tensors; identity for one pod, a plain sum for a
    non-power-of-two pod count (the reference's dispatch)."""
    return rdk.rd_all_reduce(x, mesh.pods, n_chunks=chunks,
                             workspace=mesh.workspace)


def rd_halving_all_reduce(x: torch.Tensor, pods: int) -> torch.Tensor:
    """Recursive-halving reduce-scatter + recursive-doubling all-gather
    over the slow axis, x (R, ...): the reference's bandwidth-optimal
    variant, step for step (which half each rank keeps follows its rank
    bit at that level)."""
    if pods == 1:
        return x
    if not _is_pow2(pods):
        return slow_sum(x, pods)
    shape = x.shape
    R = shape[0]
    flat = x.reshape(pods, R // pods, -1)
    n_el = flat.shape[-1]
    pad = (-n_el) % pods
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    buf = flat.reshape(pods, R // pods, pods, -1)     # n logical chunks
    idx = torch.arange(pods, device=x.device).reshape(pods, 1, 1, 1)
    stride, size = pods >> 1, pods
    while size > 1:
        half = size // 2
        keep_hi = ((idx // stride) % 2).bool()
        lower, upper = buf[:, :, :half], buf[:, :, half:]
        send = torch.where(keep_hi, lower, upper)
        keep = torch.where(keep_hi, upper, lower)
        buf = keep + send[torch.arange(pods, device=x.device) ^ stride]
        size, stride = half, stride >> 1
    stride = 1
    while stride < pods:
        recv = buf[torch.arange(pods, device=x.device) ^ stride]
        bit = ((idx // stride) % 2).bool()
        buf = torch.where(bit, torch.cat([recv, buf], dim=2),
                          torch.cat([buf, recv], dim=2))
        stride <<= 1
    out = buf.reshape(pods, R // pods, -1)
    if pad:
        out = out[..., :n_el]
    return out.reshape(shape)


def _slow_phase(x: torch.Tensor, ctx: ParallelCtx,
                mesh: VirtualMesh) -> torch.Tensor:
    pods = _sizes(ctx, mesh)[0]
    if ctx.ar_strategy == "hier_ring":
        return slow_sum(x, pods)
    if ctx.ar_strategy == "hier_rd":
        return rd_all_reduce(x, mesh, chunks=ctx.rd_chunks)
    if ctx.ar_strategy == "hier_rd_halving":
        return rd_halving_all_reduce(x, pods)
    raise ValueError(ctx.ar_strategy)  # pragma: no cover


# ---------------------------------------------------------------------------
# Fast-axis reduce-scatter and all-gather (tiled, as lax.psum_scatter /
# lax.all_gather with tiled=True)
# ---------------------------------------------------------------------------


def _fast_reduce_scatter(x: torch.Tensor, pods: int, fast: int,
                         dim: int) -> torch.Tensor:
    """x (R, *s) -> (R, *s with s[dim] / fast): rank (p, f) gets the sum
    over its fast row of piece f along ``dim``."""
    s = x.shape[1:]
    if s[dim] % fast:
        raise ValueError(f"scatter dim of size {s[dim]} is not divisible "
                         f"by the fast axis ({fast})")
    piece = s[dim] // fast
    y = x.reshape(pods, fast, *s[:dim], fast, piece, *s[dim + 1:]).sum(1)
    y = y.movedim(1 + dim, 1)
    return y.reshape(pods * fast, *s[:dim], piece, *s[dim + 1:])


def _fast_all_gather(y: torch.Tensor, pods: int, fast: int,
                     dim: int) -> torch.Tensor:
    """y (R, *s) -> (R, *s with s[dim] * fast): every rank of a fast row
    gets its row's pieces concatenated along ``dim``."""
    s = y.shape[1:]
    full = y.reshape(pods, fast, *s).movedim(1, 1 + dim)
    full = full.reshape(pods, *s[:dim], fast * s[dim], *s[dim + 1:])
    full = full.unsqueeze(1).expand(pods, fast, *full.shape[1:])
    return full.reshape(pods * fast, *full.shape[2:])


# ---------------------------------------------------------------------------
# The entry points (used by every TP layer)
# ---------------------------------------------------------------------------


def _tp_all_reduce_fp(x: torch.Tensor, ctx: ParallelCtx, mesh: VirtualMesh,
                      scatter_dim: int) -> torch.Tensor:
    """Full-precision-wire all-reduce body."""
    fast_axes, slow_axes = ctx.tp_fast, ctx.tp_slow
    pods, fast = _sizes(ctx, mesh)
    if ctx.ar_strategy == "flat" or (not slow_axes and len(fast_axes) <= 1):
        # single-level group: one plain sum (the library all-reduce)
        return x.sum(0, keepdim=True).expand_as(x)
    dim = scatter_dim % (x.dim() - 1)
    if not fast_axes:
        return _slow_phase(x, ctx, mesh)
    # Phase 1: reduce-scatter over the fast level (paper Eq. 3).
    y = _fast_reduce_scatter(x, pods, fast, dim)
    # Phase 2: recursive doubling (or ring, or halving) over the slow
    # level (Eq. 4).
    y = _slow_phase(y, ctx, mesh)
    # Phase 3: all-gather over the fast level (Eq. 5).
    return _fast_all_gather(y, pods, fast, dim)


def tp_all_reduce(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                  scatter_dim: int = -1) -> torch.Tensor:
    """All-reduce a TP partial sum (R, ...) according to the configured
    strategy: the operation the paper optimizes, twice per layer on a
    (B, 1, d_model) tensor in decode.  ``scatter_dim`` (of one rank's
    tensor) is where the hierarchical strategies reduce-scatter over the
    fast axis; it must be divisible by the fast size."""
    if not ctx.has_tp:
        return x
    ctx = _resolve_auto(x, ctx, mesh)
    _unported(ctx)
    return _tp_all_reduce_fp(x, ctx, mesh, scatter_dim)


def tp_reduce_scatter(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                      dim: int) -> torch.Tensor:
    """Reduce TP partials and leave the result sharded on ``dim`` over
    the fast axis; the slow phase runs in full (``flat`` as one sum over
    the pods, every hierarchical strategy through its own slow phase)."""
    if not ctx.has_tp:
        return x
    ctx = _resolve_auto(x, ctx, mesh)
    _unported(ctx)
    pods, fast = _sizes(ctx, mesh)
    dim = dim % (x.dim() - 1)
    if ctx.tp_fast:
        x = _fast_reduce_scatter(x, pods, fast, dim)
    if ctx.tp_slow:
        x = slow_sum(x, pods) if ctx.ar_strategy == "flat" \
            else _slow_phase(x, ctx, mesh)
    return x


def tp_all_gather(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                  dim: int) -> torch.Tensor:
    """Gather a fast-sharded activation back to full along ``dim``."""
    if not ctx.tp_fast:
        return x
    _unported(ctx)
    pods, fast = _sizes(ctx, mesh)
    return _fast_all_gather(x, pods, fast, dim % (x.dim() - 1))


__all__ = ["tp_all_reduce", "tp_reduce_scatter", "tp_all_gather",
           "rd_all_reduce", "rd_halving_all_reduce", "axes_size", "tp_rank",
           "dtype_name"]
