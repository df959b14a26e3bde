"""Wrapper of the Hopper grouped expert FFN kernel, ``csrc/moe_gemm.cu``
(the port of ``repro/kernels/moe_gemm/kernel.py::_moe_ffn_kernel`` and its
``moe_expert_ffn`` wrapper, which padded C and F to 128-multiples: the
CUDA kernel masks its remainders and takes the shapes as they are).

bf16 runs on the tensor cores with F split across CTAs: each CTA takes
one (expert, F slice of ``SLICE_F`` rows, token tile) of :func:`tc_plan`,
keeps h of its slice on chip (rounded to bf16 for the down product) and
writes an f32 partial of the down product to a workspace; a second launch
sums the partials in slice order.  The plan depends on (C, F) only, never
on the number of token blocks, and the wrapper holds it against the
kernel's own once per shape.  f32 runs the CUDA-core kernels (one launch,
or two past one CTA's shared memory: :func:`d_tile`).

A CUDA tensor launches the kernel (or the wrapper raises); CPU tensors
take the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from .ref import SLICE_F, moe_expert_ffn_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 7 + (_P,)
_TC_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,)
SOURCE = "moe_gemm"
# Dynamic shared memory one CTA may take on an H100 (hopper-kernels §1).
MAX_SMEM = 232448
# csrc/moe_gemm.cu, f32: token rows a CTA, and the shared memory of the
# one-launch kernel besides its (kBC, D) f32 accumulator and token rows
# (the gate/up partial sums and the h tile).
KBC = 8
SMEM_FIXED = (2 * 4 * KBC * 64 + KBC * 64) * 4
# D columns a CTA computes when all of D does not fit: the kernel's
# 2048-column down pass (kDownCols), so both forms sum in one order.
D_TILE = 2048
# csrc/moe_gemm.cu, bf16: n8 token blocks a CTA at most (kMaxNT; F rows
# a slice: ref.SLICE_F, kFS), and the CTA's shared memory for NT blocks: a
# 4-stage ring of (2 x 16 rows of wg/wu, or 32 rows of wd) x (256 + 8)
# elements plus 8 NT token rows x (16 + 8), and h^T (8 NT x (256 + 8)),
# in bf16.
MAX_TOKEN_BLOCKS = 5


def _tc_smem(nt: int) -> int:
    return 2 * (4 * (2 * 16 * 264 + 8 * nt * 24) + 8 * nt * 264)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    slice_f: int        # F rows a CTA
    n_split: int        # slices: ceil(F / slice_f)
    tile_c: int         # token rows a CTA: 8 n8 blocks of the mma
    n_tiles: int        # token tiles: ceil(C / tile_c)
    smem: int           # dynamic shared memory of a CTA


def tc_plan(C: int, F: int) -> TcPlan:
    """The bf16 kernel's plan for C token rows and F columns: as few
    token tiles of at most ``8 * MAX_TOKEN_BLOCKS`` rows as C needs, each
    a multiple of 8 rows, and F in slices of ``SLICE_F``.  D is tiled
    inside the CTA, and the token blocks' count G plays no part."""
    tiles = -(-C // (8 * MAX_TOKEN_BLOCKS))
    rows = -(-C // tiles)
    nt = -(-rows // 8)
    return TcPlan(SLICE_F, -(-F // SLICE_F), 8 * nt, -(-C // (8 * nt)),
                  _tc_smem(nt))


def workspace_floats(E: int, C: int, D: int, F: int) -> int:
    """f32 elements of the bf16 form's partials (E, n_split, C, D)."""
    return E * tc_plan(C, F).n_split * C * D


def smem_bytes(D: int, esz: int) -> int:
    """Dynamic shared memory of one CTA (``moe_ffn_smem_bytes`` in the
    source): in f32, of the one-launch kernel at this d_model; in bf16, of
    the tensor-core kernel at its largest token tile, whatever D."""
    if esz == 2:
        return _tc_smem(MAX_TOKEN_BLOCKS)
    return KBC * D * (4 + esz) + SMEM_FIXED


def d_tile(D: int, esz: int) -> int:
    """D columns one CTA's output covers: all of D in bf16 (the down pass
    tiles D inside the CTA) and in f32 while the one-launch kernel fits
    one CTA's shared memory, else ``D_TILE`` (the f32 two-launch form,
    which stages h in an f32 scratch)."""
    return D if smem_bytes(D, esz) <= MAX_SMEM else D_TILE


_checked: Dict[Tuple[int, int], TcPlan] = {}


def _checked_plan(C: int, F: int) -> TcPlan:
    """:func:`tc_plan`, held against the kernel's own plan once a shape."""
    key = (C, F)
    if key not in _checked:
        plan = tc_plan(C, F)
        fn = _build.c_function(SOURCE, "moe_ffn_tc_plan",
                               (_I, _I, ctypes.POINTER(_I)))
        got = (_I * 4)()
        smem = fn(C, F, got)
        if (tuple(got), smem) != (
                (plan.slice_f, plan.n_split, plan.tile_c, plan.n_tiles),
                plan.smem):
            raise RuntimeError(f"moe_expert_ffn: the kernel's plan "
                               f"{tuple(got)}, {smem} B differs from "
                               f"ops.tc_plan's {plan}")
        _checked[key] = plan
    return _checked[key]


def moe_expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """out[e, c] = (silu(x[g(e), c] @ wg[e]) * (x[g(e), c] @ wu[e])) @ wd[e]
    with f32 sums, in x.dtype.

    x: (G, C, D) with G dividing E: expert e reads token block
    g(e) = e // (E // G) (G == E: one block per expert, the dispatch path;
    G < E: a block shared by E / G experts, the decode path, without E
    copies); wg/wu: (E, D, F); wd: (E, F, D) -> (E, C, D).  Any D: the
    bf16 form tiles D inside a CTA, and in f32 :func:`d_tile` picks the
    kernel's form, which never changes the result."""
    if x.dim() != 3 or wg.dim() != 3 or wu.shape != wg.shape \
            or wd.dim() != 3:
        raise ValueError(f"moe_expert_ffn: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)} are not (G, C, D), (E, D, F), "
                         "(E, D, F), (E, F, D)")
    G, C, D = x.shape
    E, _, Fh = wg.shape
    if wg.shape[1] != D or wd.shape != (E, Fh, D) or G < 1 or E % G:
        raise ValueError(f"moe_expert_ffn: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wd {tuple(wd.shape)}: D, F or "
                         "the expert groups do not match")
    ops = (x, wg, wu, wd)
    if all(t.device.type == "cpu" for t in ops):
        return moe_expert_ffn_ref(x, wg, wu, wd)
    if x.device.type != "cuda" or x.dtype not in DTYPES \
            or any(t.device != x.device or t.dtype != x.dtype for t in ops):
        raise ValueError(
            "moe_expert_ffn: expected CUDA tensors of one dtype in "
            f"{DTYPES}, got {[(t.dtype, str(t.device)) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("moe_expert_ffn: operands must be contiguous")
    out = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = int(D % 8 == 0 and Fh % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in ops + (out,)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        _checked_plan(C, Fh)
        ws = torch.empty(workspace_floats(E, C, D, Fh), dtype=torch.float32,
                         device=x.device)
        fn = _build.c_function(SOURCE, "moe_ffn_tc_launch", _TC_ARGTYPES)
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), E, C, D, Fh, G, vec, stream)
    else:
        dt = d_tile(D, x.element_size())
        h = torch.empty((E, C, Fh) if dt < D else (0,), dtype=torch.float32,
                        device=x.device)
        fn = _build.c_function(SOURCE, "moe_ffn_launch", _ARGTYPES)
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                 out.data_ptr(), h.data_ptr(), E, C, D, Fh, G, dt, vec,
                 stream)
    _build.check(SOURCE, "moe_expert_ffn", err)
    moe_expert_ffn.launches += 1
    return out


moe_expert_ffn.launches = 0

__all__ = ["moe_expert_ffn", "moe_expert_ffn_ref", "d_tile", "smem_bytes",
           "D_TILE", "SLICE_F", "TcPlan", "tc_plan", "workspace_floats"]
