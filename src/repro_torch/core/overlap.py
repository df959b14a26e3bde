"""Overlapped collective matmul: the row-parallel projection and its TP
all-reduce as one primitive, the port of ``repro/core/overlap.py``.

In decode every layer ends in two row-parallel projections (attention
``wo``, MLP down) whose partial sums are all-reduced at once.  Split the
output features into k column blocks and block q's all-reduce no longer
waits for block q+1's GEMM:

    for q in 0..k-1:   partial_q = x @ w[..., q]          (GEMM block q)
                       y_q = tp_all_reduce(partial_q)     (comm block q)
    y = concat(y_0..y_{k-1})

Tensors carry the ranks of a :class:`~repro_torch.core.mesh.VirtualMesh`
on their leading axis.  The projection contracts x's trailing dims with
w's leading ones, output features last: ``(R, b, s, f) @ (R, f, d)`` for
the MLP (the reference's spec ``"bsf,fd->bsd"``) and
``(R, b, s, q, h) @ (R, q, h, d)`` for attention (``"bsqh,qhd->bsd"``).

Two forms, selected by ``backend``:

* ``"fused"`` (the default): when the resolved strategy is ``hier_rd``
  over one slow axis whose size is a power of two above 1, the GEMM and
  the slow-axis recursive doubling run in the hand-written kernel
  (:mod:`repro_torch.kernels.fused_matmul_rd`, the port of the reference's
  ``collective_matmul_pallas``), which starts each column block's step-0
  exchange as soon as it is computed; the sum over the fast ranks follows
  outside it.  Every other strategy and layout takes the loop above.
* ``"lax"``: the loop above for every strategy (the reference's default
  form, kept so the tests hold both).

The reference reaches its fused kernel only with ``backend="pallas"``; the
port puts kernel 5 on the executed path under ``hier_rd``.  The fused form
sums over the pods first and over the fast ranks after, the loop form the
other way round (reduce-scatter over fast, then the pods): in bf16 the two
differ by roundings, in f32 by reassociation.

With ``ar_strategy="auto"`` the strategy is resolved once, from the
unchunked output, and shared by every block: a lookup per block on the
smaller message could pick another strategy (another sum order) than the
unfused path.

The quantized wire (``ar_quant`` int8 | int4) composes with the loop: its
groups are cap-aligned windows of the trailing feature dim, so when the
full output and every chunk's per-rank shard are multiples of the group
cap times the TP size, chunked and unchunked calls quantize the same
feature windows, bit for bit (:func:`_quant_chunk_ok`); otherwise the
call keeps one message.  Error feedback (``ef``, shaped like the output)
is sliced per block on the same boundaries and the residues
concatenated.  The legacy lossy knobs (``compress_slow``, ``quant_ag``)
always take one message.  The fused kernel runs only on an unquantized
wire: the resolved ctx has no ``ar_quant`` level and neither legacy knob,
and no EF enters the reduction (an unquantized call hands EF back
untouched, so it is reduced without it and EF is returned as it came).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import fused_matmul_rd as fmrd
from ..kernels.quant_pack import GROUP_CAP
from ..kernels.rd_allreduce.ref import is_pow2
from . import autotune
from . import hierarchical as hier
from .mesh import VirtualMesh
from .pcontext import ParallelCtx

BACKENDS = ("fused", "lax")


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's x (R, *lead, *c) times its w (R, *c, d): the contraction
    over x's trailing dims c, one batched product -> (R, *lead, d)."""
    R, d = w.shape[0], w.shape[-1]
    kd = math.prod(w.shape[1:-1])
    lead = x.shape[1:x.dim() - (w.dim() - 2)]
    out = torch.bmm(x.reshape(R, -1, kd), w.reshape(R, kd, d))
    return out.reshape(R, *lead, d)


def _resolve_auto_for_matmul(x: torch.Tensor, w: torch.Tensor,
                             ctx: ParallelCtx,
                             mesh: VirtualMesh) -> ParallelCtx:
    """Concretize ``ar_strategy="auto"`` from one rank's UNCHUNKED output
    (lead elements times the output features, in the product's dtype)."""
    if ctx.ar_strategy != "auto":
        return ctx
    out_elems = w.shape[-1] * math.prod(x.shape[1:x.dim() - (w.dim() - 2)])
    dt = torch.promote_types(x.dtype, w.dtype)
    pods, fast = hier._sizes(ctx, mesh)
    return autotune.resolve(ctx, out_elems * dt.itemsize, fast, pods,
                            hier.dtype_name(dt))


def _resolve_chunks(d_out: int, fast_size: int, requested: int) -> int:
    """Largest chunk count <= requested that divides d_out into equal
    chunks each still divisible by the fast-axis size (the fast
    reduce-scatter tiles each chunk)."""
    k = max(1, min(requested, d_out))
    while k > 1 and (d_out % k or (d_out // k) % max(1, fast_size)):
        k -= 1
    return k


def _quant_chunk_ok(d_out: int, k: int, n_scatter: int, bits: int) -> bool:
    """True when ``k`` column blocks quantize the same feature windows as
    one message: the full output and every block, split over
    ``n_scatter`` ranks, are multiples of the group cap."""
    cap = GROUP_CAP[bits] * max(1, n_scatter)
    return d_out % cap == 0 and (d_out // k) % cap == 0


def _fused_rd(xm: torch.Tensor, wm: torch.Tensor, pods: int, k: int,
              mesh: VirtualMesh) -> torch.Tensor:
    """The kernel: GEMM + recursive doubling over the pods, (R, M, N)."""
    return fmrd.collective_matmul_rd(xm, wm, pods, n_chunks=k,
                                     workspace=mesh.workspace)


def _fast_sum(y: torch.Tensor, pods: int, fast: int) -> torch.Tensor:
    """The sum over the fast ranks of each pod, on every one of them
    (``lax.psum(out, ctx.tp_fast)`` of the reference's wrapper)."""
    if fast == 1:
        return y
    s = y.reshape(pods, fast, *y.shape[1:]).sum(1, keepdim=True)
    return s.expand(pods, fast, *y.shape[1:]).reshape(y.shape)


def collective_matmul(x: torch.Tensor, w: torch.Tensor, ctx: ParallelCtx,
                      mesh: Optional[VirtualMesh], *,
                      chunks: Optional[int] = None,
                      backend: str = "fused",
                      ef: Optional[torch.Tensor] = None):
    """Row-parallel projection fused with its TP all-reduce: what
    ``tp_all_reduce(project(x, w), ef=ef)`` gives, in ``chunks`` column
    blocks (default: ``ctx.overlap_chunks`` when ``ctx.overlap_matmul``,
    else 1).  x (R, *lead, *c), w (R, *c, d) -> (R, *lead, d), or
    ``(y, new_ef)`` when ``ef`` (R, *lead, d) is given."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if chunks is None:
        chunks = ctx.overlap_chunks if ctx.overlap_matmul else 1
    if not ctx.has_tp:
        y = project(x, w)
        return (y, ef) if ef is not None else y
    d_out = w.shape[-1]
    pods, fast = hier._sizes(ctx, mesh)
    ctx = _resolve_auto_for_matmul(x, w, ctx, mesh)
    hier._unported(ctx)
    bits = hier.QUANT_BITS.get(ctx.ar_quant)
    if bits is None and ef is not None:
        # an unquantized wire leaves EF untouched: reduce without it
        return collective_matmul(x, w, ctx, mesh, chunks=chunks,
                                 backend=backend), ef
    k = _resolve_chunks(d_out, fast, chunks)
    if ctx.quant_ag or ctx.compress_slow:
        k = 1   # per-message quantization: blocks would move its groups
    if bits is not None and k > 1 \
            and not _quant_chunk_ok(d_out, k, fast * pods, bits):
        k = 1
    if backend == "fused" and bits is None and ef is None \
            and not (ctx.quant_ag or ctx.compress_slow) \
            and ctx.ar_strategy == "hier_rd" and len(ctx.tp_slow) == 1 \
            and pods > 1 and is_pow2(pods):
        R = x.shape[0]
        kd = math.prod(w.shape[1:-1])
        lead = x.shape[1:x.dim() - (w.dim() - 2)]
        y = _fused_rd(x.reshape(R, -1, kd), w.reshape(R, kd, d_out), pods, k,
                      mesh)
        return _fast_sum(y, pods, fast).reshape(R, *lead, d_out)
    if k <= 1:
        return hier.tp_all_reduce(project(x, w), ctx, mesh, scatter_dim=-1,
                                  ef=ef)
    step = d_out // k
    outs, errs = [], []
    for q in range(k):
        cols = slice(q * step, (q + 1) * step)
        partial = project(x, w[..., cols])
        if ef is None:
            outs.append(hier.tp_all_reduce(partial, ctx, mesh,
                                           scatter_dim=-1))
        else:
            yq, eq = hier.tp_all_reduce(partial, ctx, mesh, scatter_dim=-1,
                                        ef=ef[..., cols])
            outs.append(yq)
            errs.append(eq)
    y = torch.cat(outs, dim=-1)
    return (y, torch.cat(errs, dim=-1)) if ef is not None else y


def collective_matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                                     ctx: ParallelCtx,
                                     mesh: Optional[VirtualMesh], *,
                                     dim: int,
                                     chunks: Optional[int] = None
                                     ) -> torch.Tensor:
    """Sequence-parallel variant: the chunked GEMM pipelined against
    ``tp_reduce_scatter`` along ``dim`` (of one rank's output), the chunks
    along the feature dim, so the two never interact (the quantized
    wire's groups live on the feature dim: only their cap alignment
    matters).  Nothing calls it until sequence-parallel residuals arrive
    (ROADMAP item 9)."""
    if chunks is None:
        chunks = ctx.overlap_chunks if ctx.overlap_matmul else 1
    if not ctx.has_tp:
        return project(x, w)
    d_out = w.shape[-1]
    ctx = _resolve_auto_for_matmul(x, w, ctx, mesh)
    k = _resolve_chunks(d_out, 1, chunks)
    if ctx.compress_slow:
        k = 1
    bits = hier.QUANT_BITS.get(ctx.ar_quant)
    if bits is not None and k > 1 and not _quant_chunk_ok(d_out, k, 1, bits):
        k = 1
    if k <= 1:
        return hier.tp_reduce_scatter(project(x, w), ctx, mesh, dim=dim)
    step = d_out // k
    return torch.cat([hier.tp_reduce_scatter(
        project(x, w[..., q * step:(q + 1) * step]), ctx, mesh, dim=dim)
        for q in range(k)], dim=-1)


__all__ = ["collective_matmul", "collective_matmul_reduce_scatter",
           "project", "BACKENDS"]
