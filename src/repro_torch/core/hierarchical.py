"""Hierarchical all-reduce strategies over the virtual mesh: the port of
``repro/core/hierarchical.py``, the full-precision wire and the quantized
one.

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
:func:`repro_torch.core.autotune.resolve` (``_resolve_auto``), and under
``ar_quant="auto"`` picks the wire level as well.

The quantized wire (``ar_quant`` int8 | int4) carries packed payloads and
per-group bf16 scales on every phase: a packed all-to-all reduce-scatter
with a local dequantize-sum, a symmetric quantized recursive doubling over
the pods (``hier_rd``, ``hier_rd_halving``; ``hier_ring`` sums the pods in
bf16) and a packed all-gather; under ``flat`` both axes are
reduce-scattered, pod first, and gathered model first.  Every pack and
unpack goes through :mod:`repro_torch.kernels.quant_pack` (kernel 6 on
CUDA tensors), and the quantized recursive doubling through
:mod:`repro_torch.kernels.quant_rd_allreduce` (its packs, exchanges and
unpacks in one launch on CUDA tensors).  On the virtual mesh an exchange
is an index across the rank axis, viewed as (pods, fast): the
reference's ``lax.all_to_all`` over an axis is a transpose of that axis
with the piece axis, ``lax.all_gather`` a broadcast of the axis into a
new one, and the XOR ``lax.ppermute`` an index of the pods; the unpack
reads the transpose and the broadcast as views, and sums a reduce-
scatter's received pieces in the same pass.  Error feedback (``ef``):
the first reduce-scatter stage is where a rank's own contribution is
rounded, so the call returns ``err = v - deq(Q(v))`` (written by the
pack) for the caller to add to its next message.  The legacy int8 knobs
(``compress_slow``, ``quant_ag``) use the standalone pack and unpack at
bits 8, group 128.  ``tp_reduce_scatter`` and ``tp_all_gather`` are the
two halves of the sequence-parallel residual (``seq_parallel``, which the
collectives themselves ignore).

Training (``parallel/steps.py::build_train_step``) sums each gradient leaf
over the pods of a data-parallel ``VirtualMesh(pods, 1)``
(:func:`grad_cross_pod_reduce`, the paper's inter-node phase applied to
gradients: ``grad_reduce_strategy`` flat | rd (kernel 4) | rd_int8 (the
int8 recursive doubling, kernel 6's pack and unpack)), in pieces of at
most ``GRAD_PIECE`` elements a rank, and averages the loss over the
batch axes (:func:`dp_psum_mean`).

The MoE layer's exchanges live here too: ``ep_all_to_all`` (the dispatch's
``lax.all_to_all`` over the EP axes, which are the TP axes: a transpose of
the rank and piece axes), ``ep_rank``/``ep_size`` (each rank's expert
offset) and ``all_gather_tiled`` (the prefill's gather of the ranks'
sequence chunks).

On a pipeline mesh (``parallel/pp.py``) the slow axis is the stage axis,
not a TP axis: the rank axis then stacks ``_groups`` independent TP groups
of ``fast`` ranks each, stage-major, and the fast-axis sum (every
strategy's, with no slow TP axis), ``tp_rank``, ``ep_rank``,
``ep_all_to_all`` and ``all_gather_tiled`` act within each group.  The
sequence-parallel halves and the quantized wire are not taken there
(``pp.check_pp_layout`` refuses them).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels import quant_pack as qp
from ..kernels import quant_rd_allreduce as qrd
from ..kernels import rd_allreduce as rdk
from ..kernels.quant_rd_allreduce.ref import xor_exchange as _xor_exchange
from ..kernels.rd_allreduce.ref import is_pow2 as _is_pow2
from ..kernels.rd_allreduce.ref import slow_sum
from . import autotune
from .mesh import VirtualMesh
from .pcontext import ParallelCtx
from .tree import tree_map

Mesh = Optional[VirtualMesh]

# ctx.ar_quant level -> wire bits (levels beyond "none"/"auto").
QUANT_BITS = {"int8": 8, "int4": 4}

# The axes of the (pods, fast, *s) view of a rank-stacked tensor.
SLOW, FAST = 0, 1


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


def _groups(ctx: ParallelCtx, mesh: Mesh) -> int:
    """The independent TP groups on the rank axis: 1, except on a
    pipeline mesh, whose stage axis is not a TP axis: there group g is
    ranks g * fast .. (g + 1) * fast - 1, one a stage."""
    if mesh is None:
        return 1
    pods, fast = _sizes(ctx, mesh)
    return mesh.size // (pods * fast)


def _group_sum(x: torch.Tensor, ctx: ParallelCtx,
               mesh: Mesh) -> torch.Tensor:
    """The sum over each TP group's ranks of x (R, ...), on every rank of
    the group."""
    G = _groups(ctx, mesh)
    y = x.reshape(G, x.shape[0] // G, *x.shape[1:])
    return y.sum(1, keepdim=True).expand_as(y).reshape(x.shape)


def _per_group(n: int, ctx: ParallelCtx, mesh: Mesh,
               device) -> torch.Tensor:
    """0 .. n-1 on each TP group's ranks, (R,) int64; one group (every
    mesh but a pipeline's) copies nothing."""
    r = torch.arange(n, device=device)
    G = _groups(ctx, mesh)
    return r.repeat(G) if G > 1 else r


def tp_rank(ctx: ParallelCtx, mesh: Mesh, device=None) -> torch.Tensor:
    """Every rank's linear index in its TP group (slow axes outermost),
    (R,) int64: ``layers.tp_rank`` for all ranks at once."""
    pods, fast = _sizes(ctx, mesh) if ctx.has_tp else (1, 1)
    return _per_group(pods * fast, ctx, mesh, device)


def ep_size(ctx: ParallelCtx, mesh: Mesh) -> int:
    """Ranks of the expert-parallel group (1 without ``ep``).  On a mesh
    the experts are sharded over every TP axis, so a MoE layer needs
    ``ep`` to be those axes (``VirtualMesh.check_ctx`` refuses any other
    non-empty set; an empty one is refused here)."""
    if not ctx.ep:
        if ctx.has_tp and axes_size(ctx.tp_axes, mesh) > 1:
            raise ValueError(f"a MoE layer over TP axes {ctx.tp_axes} needs "
                             "ep = the TP axes, got none")
        return 1
    return axes_size(ctx.ep, mesh)


def ep_rank(ctx: ParallelCtx, mesh: Mesh, device=None) -> torch.Tensor:
    """Every rank's index in the expert-parallel group (R,) int64, the
    reference's ``tp_rank`` over ``ctx.ep`` (slow axes outermost): rank r
    holds experts ``ep_rank[r] * E_loc`` onwards."""
    return _per_group(ep_size(ctx, mesh), ctx, mesh, device)


def ep_all_to_all(t: torch.Tensor, ctx: ParallelCtx,
                  mesh: Mesh) -> torch.Tensor:
    """``lax.all_to_all(t, ctx.ep, split_axis=0, concat_axis=0,
    tiled=True)`` of every rank's (ep, *s) pieces, t (R, ep, *s): rank j's
    piece i goes to rank i as its piece j.  The EP group is the TP group,
    so the exchange is the transpose of the rank and piece axes within
    each group."""
    G, ep = _groups(ctx, mesh), ep_size(ctx, mesh)
    if t.shape[1] != ep or t.shape[0] != G * ep:
        raise ValueError(f"ep_all_to_all: pieces {tuple(t.shape[:2])} are "
                         f"not (R, ep) with R = {G} x ep")
    return _all_to_all(t.reshape(G, ep, *t.shape[1:]), 1, 2).reshape(
        t.shape)


def all_gather_tiled(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                     dim: int) -> torch.Tensor:
    """``lax.all_gather(x, ctx.tp_axes, axis=dim, tiled=True)``: every
    rank's piece along ``dim`` (of one rank's tensor) concatenated in rank
    order (slow-major), the same on every rank of the TP group.  x (R, *s)
    -> (R, *s') with s'[dim] = T s[dim], T ranks a group (R at one group:
    an expanded view)."""
    if not ctx.has_tp:
        return x
    R, G = x.shape[0], _groups(ctx, mesh)
    d = dim % (x.dim() - 1)
    y = x.reshape(G, R // G, *x.shape[1:]).movedim(1, 1 + d)
    y = y.reshape(G, *y.shape[1:1 + d], -1, *y.shape[3 + d:])
    return y.unsqueeze(1).expand(G, R // G, *y.shape[1:]).reshape(
        R, *y.shape[1:])


def pod_all_gather_tiled(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                         dim: int) -> torch.Tensor:
    """``lax.all_gather(x, ctx.tp_slow, axis=dim, tiled=True)``: the pods'
    pieces along ``dim`` concatenated in pod order on every rank of a fast
    column.  x (R, *s) -> (R, *s'), s'[dim] = pods s[dim]."""
    pods, fast = _sizes(ctx, mesh)
    if pods == 1:
        return x
    d = dim % (x.dim() - 1)
    y = x.reshape(pods, fast, *x.shape[1:]).movedim(0, 1 + d)
    y = y.reshape(fast, *x.shape[1:1 + d], pods * x.shape[1 + d],
                  *x.shape[2 + d:])
    return y.unsqueeze(0).expand(pods, *y.shape).reshape(x.shape[0],
                                                         *y.shape[1:])


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


def compressed_rd_all_reduce(x: torch.Tensor, pods: int,
                             group: int = 128) -> torch.Tensor:
    """Recursive doubling over the slow axis with int8 exchanges
    (``compress_slow``), x (R, ...): each step packs the outgoing partial
    (bits 8, ``group``), and each rank adds the dequantized payload of its
    XOR peer to its own unquantized accumulator (so peers may drift
    apart by a rounding, as in the reference)."""
    if pods == 1:
        return x
    if not _is_pow2(pods):
        return slow_sum(x, pods)
    acc = x.reshape(pods, x.shape[0] // pods, -1).float()
    m = acc.shape[-1]
    pad = (-m) % group
    if pad:
        acc = F.pad(acc, (0, pad))
    step = 1
    while step < pods:
        q, s = qp.quantize_pack(acc, 8, group)
        acc = acc + qp.unpack_dequant(_xor_exchange(q, SLOW, step),
                                      _xor_exchange(s, SLOW, step), 8, group)
        step <<= 1
    return acc[..., :m].reshape(x.shape).to(x.dtype)


def _slow_reduce(x: torch.Tensor, algo: str, pods: int, mesh: VirtualMesh,
                 chunks) -> torch.Tensor:
    """The sum over the pods by one algorithm: ``flat`` the plain sum,
    ``rd`` recursive doubling (kernel 4), ``rd_int8`` recursive doubling
    with int8 exchanges, ``rd_halving`` halving-doubling."""
    if algo == "flat":
        return slow_sum(x, pods)
    if algo == "rd":
        return rd_all_reduce(x, mesh, chunks=chunks)
    if algo == "rd_int8":
        return compressed_rd_all_reduce(x, pods)
    if algo == "rd_halving":
        return rd_halving_all_reduce(x, pods)
    raise ValueError(algo)


# The slow phase's algorithm under each hierarchical ``ar_strategy``.
_SLOW_ALGO = {"hier_ring": "flat", "hier_rd": "rd",
              "hier_rd_halving": "rd_halving"}


def _slow_phase(x: torch.Tensor, ctx: ParallelCtx,
                mesh: VirtualMesh) -> torch.Tensor:
    algo = _SLOW_ALGO.get(ctx.ar_strategy)
    if algo is None:
        raise ValueError(ctx.ar_strategy)  # pragma: no cover
    if algo == "rd" and ctx.compress_slow:
        algo = "rd_int8"
    return _slow_reduce(x, algo, _sizes(ctx, mesh)[0], mesh, ctx.rd_chunks)


# ---------------------------------------------------------------------------
# Gradient reduction across pods (training)
# ---------------------------------------------------------------------------

# Elements a rank of one gradient piece: 16 MiB of f32, so kernel 4's
# receive buffer (steps x R x piece bytes) stays 128 MiB at 4 pods where a
# whole llama3.2-1b embedding gradient would ask 8.4 GB; a multiple of the
# int8 groups (128), so every piece but a leaf's last holds whole groups
# and rd_int8 quantizes the leaf's own groups.
GRAD_PIECE = 2**22


def grad_cross_pod_reduce(grads, ctx: ParallelCtx, mesh: Mesh):
    """Every leaf (R, ...) of the tree ``grads`` (:mod:`.tree`) summed
    over the pods (the slow axis of ``mesh``, which must be the ctx's one
    pod axis: a ``dp`` axis no ``fsdp`` axis covers) on every rank, by
    ``ctx.grad_reduce_strategy`` (:func:`_slow_reduce`): ``flat`` the
    plain sum, ``rd`` recursive doubling (kernel 4 on CUDA
    tensors), ``rd_int8`` recursive doubling with int8 exchanges (kernel
    6's pack and unpack on CUDA tensors; the pods' copies may drift apart
    by a rounding, as in the reference).  A sum, not a mean.  Each leaf
    goes in pieces of at most ``GRAD_PIECE`` elements a rank (the
    per-element sums, and rd_int8's groups of 128, are the whole
    leaf's); the result is written into the leaves in place and the tree
    returned.  Identity without pod axes or at one pod."""
    axes = tuple(a for a in ctx.dp if a not in ctx.fsdp)
    if not axes or mesh is None or mesh.pods == 1:
        return grads
    if axes != (mesh.slow_axis,):
        raise ValueError(f"pod axes {axes} are not the mesh's slow axis "
                         f"{mesh.slow_axis!r}")

    def leaf(g: torch.Tensor) -> torch.Tensor:
        flat = g.view(g.shape[0], -1)
        for a in range(0, flat.shape[1], GRAD_PIECE):
            part = flat[:, a:a + GRAD_PIECE]
            part.copy_(_slow_reduce(part.contiguous(),
                                    ctx.grad_reduce_strategy, mesh.pods,
                                    mesh, ctx.rd_chunks))
        return g

    return tree_map(leaf, grads)


def dp_psum_mean(x: torch.Tensor, ctx: ParallelCtx,
                 mesh: Mesh) -> torch.Tensor:
    """The mean over the batch-parallel ranks of a per-rank value x (R,
    ...) on every rank: ``lax.psum(x, ctx.dp) / size``, ``ctx.dp`` the
    mesh's slow axis (the pods of each fast column).  Without a mesh
    (every axis of size 1) x itself."""
    if not ctx.dp or mesh is None or mesh.pods == 1:
        return x
    if tuple(ctx.dp) != (mesh.slow_axis,):
        raise ValueError(f"dp axes {ctx.dp} are not the mesh's slow axis "
                         f"{mesh.slow_axis!r}")
    y = x.reshape(mesh.pods, x.shape[0] // mesh.pods, *x.shape[1:])
    return y.mean(0, keepdim=True).expand_as(y).reshape(x.shape)


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
# Quantized collective phases (ar_quant = int8 | int4)
# ---------------------------------------------------------------------------
#
# These work on the (pods, fast, *s) view t of a rank-stacked tensor, an
# axis being SLOW or FAST and ``dim`` a dim of one rank's tensor *s.  The
# reference's exchanges of packed payloads become index operations on it.


def _axes(ctx: ParallelCtx):
    """(slow, fast) axis tuples of the ctx on the (pods, fast) view."""
    return (SLOW,) if ctx.tp_slow else (), (FAST,) if ctx.tp_fast else ()


def _all_to_all(t: torch.Tensor, axis: int, piece: int) -> torch.Tensor:
    """``lax.all_to_all`` over ``axis`` with the piece dim ``piece`` (of
    size n, split and concatenated in place): rank j's piece i is rank
    i's piece j, a transpose of the two."""
    return t.transpose(axis, piece)


def _all_gather(t: torch.Tensor, axis: int) -> torch.Tensor:
    """``lax.all_gather(axis=0, tiled=False)`` over ``axis``: (P, F, *s) ->
    (P, F, n, *s), every rank holding the n tensors of its ``axis`` group
    stacked in axis order."""
    P, Fn = t.shape[:2]
    if axis == FAST:
        return t.unsqueeze(1).expand(P, Fn, *t.shape[1:])
    return t.transpose(0, 1).unsqueeze(0).expand(P, Fn, P, *t.shape[2:])


def _psum(t: torch.Tensor, axes) -> torch.Tensor:
    return t.sum(axes, keepdim=True).expand_as(t)


def quant_rd_all_reduce(t: torch.Tensor, axis: int, bits: int,
                        workspace: Optional[rdk.RDWorkspace] = None
                        ) -> torch.Tensor:
    """Recursive doubling over ``axis`` of t (P, F, *s) with a symmetric
    low-bit exchange: BOTH peers of a step requantize, ``acc <- deq(Q(acc))
    + deq(Q(acc_peer))``, so the two compute one sum and the result is
    exactly replicated across the axis.  Each rank's message is grouped at
    the cap, as if padded with zeros to a multiple of 256.  On CUDA
    tensors one launch of the quantized RD kernel, which needs the mesh's
    ``workspace``; on CPU tensors its plain loop."""
    n = t.shape[axis]
    if n == 1:
        return t
    if not _is_pow2(n):
        return _psum(t, axis)
    return qrd.quant_rd_all_reduce(t, axis, bits, workspace=workspace)


def _pad_last(t: torch.Tensor, mult: int):
    pad = (-t.shape[-1]) % mult
    return (F.pad(t, (0, pad)) if pad else t), pad


def _quant_rs_one(v: torch.Tensor, axis: int, dim: int, bits: int,
                  want_err: bool):
    """One-axis reduce-scatter on a packed low-bit wire, v (P, F, *s) f32:
    splits ``dim`` into per-rank pieces, exchanges the packed pieces and
    sums their dequantized values locally -> (scattered f32, err f32 or
    None), ``err = v - deq(Q(v))`` over the full pre-scatter shape."""
    n = v.shape[axis]
    if n == 1:
        return v, (torch.zeros_like(v) if want_err else None)
    nd = v.dim() - 2
    dim = dim % nd
    if dim == nd - 1:
        # one pack (with the EF residue), then the received pieces read
        # through the all-to-all's transpose and summed in one unpack
        shard = v.shape[-1] // n
        group = qp.group_for(shard, bits)
        packed = qp.quantize_pack(v.reshape(*v.shape[:-1], n, shard), bits,
                                  group, err=want_err)
        q, s = packed[:2]
        piece = q.dim() - 2
        red = qp.unpack_dequant(_all_to_all(q, axis, piece),
                                _all_to_all(s, axis, piece), bits, group,
                                piece_dim=piece)
        return red, (packed[2].reshape(v.shape) if want_err else None)
    # Scatter along a non-trailing dim: groups stay on the feature (last)
    # dim, untouched by the split.
    size = v.shape[2 + dim]
    vm = v.movedim(2 + dim, 2)
    rest = vm.shape[3:]
    vm = vm.reshape(*vm.shape[:2], n, size // n, *rest)
    vmp, pad = (vm, 0)
    if bits == 4 and vm.shape[-1] % 2:
        vmp, pad = _pad_last(vm, 2)
    group = qp.group_for(vmp.shape[-1], bits)
    q, s = qp.quantize_pack(vmp, bits, group)
    deq = qp.unpack_dequant(_all_to_all(q, axis, 2), _all_to_all(s, axis, 2),
                            bits, group)
    deq_own = qp.unpack_dequant(q, s, bits, group) if want_err else None
    if pad:
        deq = deq[..., :-pad]
        deq_own = deq_own[..., :-pad] if want_err else None
    red = deq.sum(2).movedim(2, 2 + dim)
    err = None
    if want_err:
        own = deq_own.reshape(*v.shape[:2], size, *rest).movedim(2, 2 + dim)
        err = v - own
    return red, err


def _quant_reduce_scatter(v: torch.Tensor, axes, dim: int, bits: int,
                          want_err: bool):
    """Reduce-scatter over ``axes`` (in order) on the packed wire; ``err``
    is the FIRST stage's rounding of ``v`` (where this rank's own
    contribution is quantized; later stages requantize partial sums,
    which error feedback by design does not chase)."""
    err = None
    for i, ax in enumerate(axes):
        v, e = _quant_rs_one(v, ax, dim, bits, want_err and i == 0)
        if i == 0:
            err = e
    return v, err


def _quant_ag_one(y: torch.Tensor, axis: int, dim: int,
                  bits: int) -> torch.Tensor:
    n = y.shape[axis]
    if n == 1:
        return y
    nd = y.dim() - 2
    dim = dim % nd
    yp, pad = (y, 0)
    if bits == 4 and y.shape[-1] % 2:
        yp, pad = _pad_last(y, 2)
    group = qp.group_for(yp.shape[-1], bits)
    q, s = qp.quantize_pack(yp, bits, group)
    qg, sg = _all_gather(q, axis), _all_gather(s, axis)   # (P, F, n, *s)
    if pad:
        deq = qp.unpack_dequant(qg, sg, bits, group)[..., :-pad]
        out = deq.movedim(2, 2 + dim)                # n right before dim
    else:
        # the unpack writes each gathered piece where the result wants it
        out = torch.empty((*y.shape[:2 + dim], n, *y.shape[2 + dim:]),
                          dtype=torch.float32, device=y.device)
        qp.unpack_dequant(qg, sg, bits, group, out=out.movedim(2 + dim, 2))
    return out.reshape(*y.shape[:2 + dim], n * y.shape[2 + dim],
                       *y.shape[3 + dim:])


def _quant_all_gather(y: torch.Tensor, axes, dim: int,
                      bits: int) -> torch.Tensor:
    """All-gather over ``axes`` on the packed wire, in the inverse order of
    :func:`_quant_reduce_scatter` (the last axis gathered first)."""
    for ax in reversed(axes):
        y = _quant_ag_one(y, ax, dim, bits)
    return y


def _quant_slow_phase(t: torch.Tensor, slow, ctx: ParallelCtx, bits: int,
                      mesh: Mesh) -> torch.Tensor:
    """The slow phase under ar_quant: the recursive-doubling strategies
    carry the quantized exchange; ring and flat sum the pods in bf16."""
    for ax in slow:
        if ctx.ar_strategy in ("hier_rd", "hier_rd_halving"):
            t = quant_rd_all_reduce(t, ax, bits, mesh.workspace)
        else:
            t = _psum(t.to(torch.bfloat16), ax).to(t.dtype)
    return t


def _quant_scatter_ok(t: torch.Tensor, fast, dim: int, bits: int) -> bool:
    """Shape guard of the packed reduce-scatter: every axis split must
    divide the scatter dim, and an int4 trailing-dim shard must be even;
    otherwise the call keeps the full-precision wire."""
    nd = t.dim() - 2
    dim = dim % nd
    size = t.shape[2 + dim]
    for ax in fast:
        n = t.shape[ax]
        if size % n:
            return False
        size //= n
    return not (bits == 4 and dim == nd - 1 and size % 2)


def _quant_tp_all_reduce(x: torch.Tensor, ctx: ParallelCtx,
                         mesh: VirtualMesh, scatter_dim: int,
                         ef: Optional[torch.Tensor]):
    """Quantized-wire all-reduce, x (R, *s): RS(packed) + slow(packed RD)
    + AG(packed).  Returns (y, new_ef); ``new_ef`` is None iff ``ef`` is
    None, else the residue this rank must re-inject next step."""
    bits = QUANT_BITS[ctx.ar_quant]
    pods, fast_n = _sizes(ctx, mesh)
    slow, fast = _axes(ctx)
    if ctx.ar_strategy == "flat":
        # one level: RS + AG over every TP axis, pod first, is the
        # all-reduce's decomposition with packed payloads
        fast, slow = slow + fast, ()
    t = x.reshape(pods, fast_n, *x.shape[1:])
    dim = scatter_dim % (x.dim() - 1)
    v = t.float()
    if ef is not None:
        v = v + ef.reshape(t.shape).float()
    if not fast:
        # slow-only group: the quantized RD rounds the whole exchange and
        # there is no per-rank RS rounding to feed back
        y = _quant_slow_phase(v, slow, ctx, bits, mesh)
        return y.reshape(x.shape).to(x.dtype), \
            (torch.zeros_like(v).reshape(x.shape) if ef is not None else None)
    if not _quant_scatter_ok(t, fast, dim, bits):
        return _psum(t, (SLOW, FAST)).reshape(x.shape), ef
    red, err = _quant_reduce_scatter(v, fast, dim, bits,
                                     want_err=ef is not None)
    if slow:
        red = _quant_slow_phase(red, slow, ctx, bits, mesh)
    y = _quant_all_gather(red, fast, dim, bits)
    return y.reshape(x.shape).to(x.dtype), \
        (None if err is None else err.reshape(x.shape))


def quantized_all_gather(x: torch.Tensor, pods: int, fast: int, dim: int,
                         group: int = 128) -> torch.Tensor:
    """All-gather over the fast axis with an int8 payload and per-group
    bf16 scales (``quant_ag``), x (R, *s): each rank's slice, moved to the
    last dim and flattened, is packed at bits 8, gathered and stitched
    back along ``dim``."""
    t = x.reshape(pods, fast, *x.shape[1:])
    moved = t.movedim(2 + dim, -1)
    flat = moved.reshape(pods, fast, -1)
    m = flat.shape[-1]
    pad = (-m) % group
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = qp.quantize_pack(flat, 8, group)
    deq = qp.unpack_dequant(_all_gather(q, FAST), _all_gather(s, FAST), 8,
                            group)[..., :m]           # (P, F, n, m)
    out = deq.reshape(pods, fast, fast, *moved.shape[2:]).movedim(2, -2)
    out = out.reshape(*out.shape[:-2], fast * moved.shape[-1])
    out = out.movedim(-1, 2 + dim)
    return out.reshape(x.shape[0], *out.shape[2:]).to(x.dtype)


# ---------------------------------------------------------------------------
# The entry points (used by every TP layer)
# ---------------------------------------------------------------------------


def _tp_all_reduce_fp(x: torch.Tensor, ctx: ParallelCtx, mesh: VirtualMesh,
                      scatter_dim: int) -> torch.Tensor:
    """Full-precision-wire all-reduce body (``quant_ag`` packs only the
    all-gather)."""
    fast_axes, slow_axes = ctx.tp_fast, ctx.tp_slow
    pods, fast = _sizes(ctx, mesh)
    if (ctx.ar_strategy == "flat" or (not slow_axes and len(fast_axes) <= 1)) \
            and not ctx.quant_ag:
        # single-level group: one plain sum (the library all-reduce)
        return _group_sum(x, ctx, mesh)
    dim = scatter_dim % (x.dim() - 1)
    if not fast_axes:
        return _slow_phase(x, ctx, mesh)
    # Phase 1: reduce-scatter over the fast level (paper Eq. 3).
    y = _fast_reduce_scatter(x, pods, fast, dim)
    # Phase 2: recursive doubling (or ring, or halving) over the slow
    # level (Eq. 4); ``flat`` (here only with quant_ag) sums the pods.
    if slow_axes:
        y = _slow_phase(y, ctx if ctx.ar_strategy != "flat"
                        else ctx.replace(ar_strategy="hier_ring"), mesh)
    # Phase 3: all-gather over the fast level (Eq. 5).
    if ctx.quant_ag:
        return quantized_all_gather(y, pods, fast, dim)
    return _fast_all_gather(y, pods, fast, dim)


def tp_all_reduce(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                  scatter_dim: int = -1, ef: Optional[torch.Tensor] = None):
    """All-reduce a TP partial sum (R, ...) according to the configured
    strategy: the operation the paper optimizes, twice per layer on a
    (B, 1, d_model) tensor in decode.  ``scatter_dim`` (of one rank's
    tensor) is where the hierarchical strategies reduce-scatter over the
    fast axis; it must be divisible by the fast size.

    ``ctx.ar_quant`` in {int8, int4} (forced, or resolved per call under
    ``ar_quant="auto"``) takes the packed low-bit wire.  ``ef`` is this
    call site's error-feedback accumulator, shaped like x: when given the
    call returns ``(y, new_ef)``; the quantized paths add it to the
    message and return the fresh rounding residue (f32), unquantized
    paths hand it back untouched, so call sites thread EF unconditionally.
    Without ``ef`` the return is the plain tensor."""
    if not ctx.has_tp:
        return (x, ef) if ef is not None else x
    ctx = _resolve_auto(x, ctx, mesh)
    if ctx.ar_quant in QUANT_BITS:
        y, ef2 = _quant_tp_all_reduce(x, ctx, mesh, scatter_dim, ef)
        return (y, ef2) if ef is not None else y
    y = _tp_all_reduce_fp(x, ctx, mesh, scatter_dim)
    return (y, ef) if ef is not None else y


def tp_reduce_scatter(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                      dim: int) -> torch.Tensor:
    """Reduce TP partials and leave the result sharded on ``dim`` over
    the fast axis; the slow phase runs in full (``flat`` as one sum over
    the pods, every hierarchical strategy through its own slow phase;
    under ar_quant the packed RS and the quantized slow phase)."""
    if not ctx.has_tp:
        return x
    ctx = _resolve_auto(x, ctx, mesh)
    pods, fast = _sizes(ctx, mesh)
    dim = dim % (x.dim() - 1)
    slow_ax, fast_ax = _axes(ctx)
    if ctx.ar_quant in QUANT_BITS and fast_ax:
        bits = QUANT_BITS[ctx.ar_quant]
        t = x.reshape(pods, fast, *x.shape[1:])
        if _quant_scatter_ok(t, fast_ax, dim, bits):
            y, _ = _quant_reduce_scatter(t.float(), fast_ax, dim, bits,
                                         want_err=False)
            y = _quant_slow_phase(y, slow_ax, ctx, bits, mesh)
            return y.reshape(x.shape[0], *y.shape[2:]).to(x.dtype)
    if ctx.tp_fast:
        x = _fast_reduce_scatter(x, pods, fast, dim)
    if ctx.tp_slow:
        x = slow_sum(x, pods) if ctx.ar_strategy == "flat" \
            else _slow_phase(x, ctx, mesh)
    return x


def tp_all_gather(x: torch.Tensor, ctx: ParallelCtx, mesh: Mesh,
                  dim: int) -> torch.Tensor:
    """Gather a fast-sharded activation back to full along ``dim`` (on the
    packed wire under a forced ar_quant level, at int8 under quant_ag)."""
    if not ctx.tp_fast:
        return x
    pods, fast = _sizes(ctx, mesh)
    dim = dim % (x.dim() - 1)
    if ctx.ar_quant in QUANT_BITS:
        t = x.reshape(pods, fast, *x.shape[1:]).float()
        y = _quant_all_gather(t, (FAST,), dim, QUANT_BITS[ctx.ar_quant])
        return y.reshape(x.shape[0], *y.shape[2:]).to(x.dtype)
    if ctx.quant_ag:
        return quantized_all_gather(x, pods, fast, dim)
    return _fast_all_gather(x, pods, fast, dim)


__all__ = ["tp_all_reduce", "tp_reduce_scatter", "tp_all_gather",
           "rd_all_reduce", "rd_halving_all_reduce",
           "compressed_rd_all_reduce", "quant_rd_all_reduce",
           "quantized_all_gather", "axes_size", "tp_rank", "dtype_name",
           "ep_size", "ep_rank", "ep_all_to_all", "all_gather_tiled",
           "pod_all_gather_tiled", "grad_cross_pod_reduce", "dp_psum_mean",
           "GRAD_PIECE", "QUANT_BITS"]
