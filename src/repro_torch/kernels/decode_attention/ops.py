"""Wrappers of the Hopper split-KV flash-decode kernels,
``csrc/decode_attention.cu``: dense (``decode_attention``) and paged through
a block table (``paged_decode_attention``).

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version in ``ref.py``.  There is no fallback between the
two: the device of the operands decides.

The kernel cuts each row's cache into splits of ``SPLIT_KEYS`` keys at
multiples of it in absolute key position: one CTA a (sequence, kv head,
split) writes an f32 partial (acc, m, l of each query head) to a
workspace the wrapper allocates with ``torch.empty``, and a second launch
merges a row's live splits in ascending order.  :func:`split_plan` is the
plan in Python; the wrapper holds it against the kernel's own numbers
once per shape.  A call is two CUDA launches and counts as one in
``.launches``.  bf16 at hd 16, 32, 64 or 128 with at most 16 query heads
a kv head runs its products on the tensor cores; f32 and the other bf16
shapes on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .. import _build
from .._checks import check_index, check_operands
from .ref import (decode_attention_ref, live_splits,
                  paged_decode_attention_ref, visible_keys)

_P, _I = ctypes.c_void_p, ctypes.c_int
_DENSE_ARGTYPES = (_P,) * 6 + (_I,) * 7 + (_P,)
_PAGED_ARGTYPES = (_P,) * 7 + (_I,) * 8 + (_P,)
SOURCE = "decode_attention"
HEAD_DIMS = tuple(range(8, 129, 8))
MAX_GROUP_WIDTH = 1024   # g * hd: query heads of one kv head, times hd
# Keys of a split, both types (csrc/decode_attention.cu kSplit).
SPLIT_KEYS = 128

_checked: Dict[Tuple, int] = {}


def workspace_floats(B: int, Hq: int, Hkv: int, hd: int, n_keys: int,
                     split: int) -> int:
    """f32 elements of a call's workspace: a partial (acc[g * hd], m[g],
    l[g]) for every (sequence, kv head, split of the grid)."""
    g = Hq // Hkv
    return B * Hkv * -(-n_keys // split) * (g * hd + 2 * g)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    split: int                   # keys a split
    n_splits: int                # grid splits a row: ceil(n_keys / split)
    live: Tuple[range, ...]      # each row's live splits, ascending
    workspace: int               # f32 elements of the partials


def split_plan(positions: Sequence[int], n_keys: int, *, Hq: int, Hkv: int,
               hd: int, window: int = 0) -> SplitPlan:
    """The kernel's plan for rows with last positions ``positions`` over
    ``n_keys`` cached keys (S dense, bs * max_blocks paged).  A row's live
    splits depend on its position, the window and the split length only."""
    return SplitPlan(SPLIT_KEYS, -(-n_keys // SPLIT_KEYS),
                     tuple(live_splits(int(p), n_keys, window, SPLIT_KEYS)
                           for p in positions),
                     workspace_floats(len(positions), Hq, Hkv, hd, n_keys,
                                      SPLIT_KEYS))


def _workspace(q: torch.Tensor, Hkv: int, n_keys: int,
               window: int) -> torch.Tensor:
    """The call's f32 workspace, its size held against the kernel's own
    plan (split length, workspace, the live splits of a few positions)
    the first time a shape is seen."""
    B, Hq, hd = q.shape
    key = (B, Hq, Hkv, hd, n_keys, window)
    if key not in _checked:
        split = SPLIT_KEYS
        got = _build.c_function(SOURCE, "decode_attention_split_keys", ())()
        n = workspace_floats(B, Hq, Hkv, hd, n_keys, split)
        ws_fn = _build.c_function(
            SOURCE, "decode_attention_workspace_floats", (_I,) * 5)
        ws_fn.restype = ctypes.c_longlong
        got_n = ws_fn(B, Hq, Hkv, hd, n_keys)
        live_fn = _build.c_function(SOURCE, "decode_attention_live_splits",
                                    (_I,) * 3 + (_P,))
        lo_hi = (ctypes.c_int * 2)()
        for p in (-1, 0, split - 1, split, 2 * split - 1, n_keys - 1):
            live_fn(p, n_keys, window, ctypes.addressof(lo_hi))
            want = live_splits(p, n_keys, window, split)
            if range(lo_hi[0], lo_hi[1] + 1) != want:
                raise RuntimeError(
                    f"decode_attention: the kernel's live splits at pos {p} "
                    f"are {lo_hi[0]}..{lo_hi[1]}, the wrapper's {want}")
        if (got, got_n) != (split, n):
            raise RuntimeError(
                f"decode_attention: the kernel's split {got} / workspace "
                f"{got_n}, the wrapper's {split} / {n}")
        _checked[key] = n
    return torch.empty(_checked[key], dtype=torch.float32, device=q.device)


def _check(name, q, k, v, Hkv):
    check_operands(name, (q, k, v), HEAD_DIMS)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if (q.shape[1] // Hkv) * q.shape[2] > MAX_GROUP_WIDTH:
        raise ValueError(f"{name}: (Hq/Hkv)*hd > {MAX_GROUP_WIDTH}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd); positions: (B,) int32, the
    last key each sequence sees -> (B, Hq, hd)."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or k.shape != (B, S, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, positions, window=window)
    _check("decode_attention", q, k, v, Hkv)
    check_index("decode_attention positions", positions, (B,), q.device)
    out = torch.empty_like(q)
    ws = _workspace(q, Hkv, S, int(window))
    fn = _build.c_function(SOURCE, "decode_attention_launch",
                           _DENSE_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
             out.data_ptr(), ws.data_ptr(), B, Hq, Hkv, S, hd, int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(SOURCE, "decode_attention", err)
    decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_phys: torch.Tensor,
                           v_phys: torch.Tensor, block_tbl: torch.Tensor,
                           positions: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k_phys/v_phys: (n_blocks, bs, Hkv, hd);
    block_tbl: (B, max_blocks) int32 logical -> physical block, each entry
    below n_blocks (not checked: that would cost a device sync per call;
    entries past a sequence's position may be the trash block 0, they are
    never read); positions: (B,) int32 -> (B, Hq, hd)."""
    B, Hq, hd = q.shape
    nb, bs, Hkv = k_phys.shape[0], k_phys.shape[1], k_phys.shape[2]
    mb = block_tbl.shape[1]
    if Hq % Hkv or k_phys.shape != (nb, bs, Hkv, hd) \
            or v_phys.shape != k_phys.shape or block_tbl.shape[0] != B:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_phys.shape)} v {tuple(v_phys.shape)} "
                         f"tbl {tuple(block_tbl.shape)}")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_phys, v_phys, block_tbl,
                                          positions, window=window)
    _check("paged_decode_attention", q, k_phys, v_phys, Hkv)
    check_index("paged_decode_attention positions", positions, (B,),
                q.device)
    check_index("paged_decode_attention block_tbl", block_tbl, (B, mb),
                q.device)
    out = torch.empty_like(q)
    ws = _workspace(q, Hkv, bs * mb, int(window))
    fn = _build.c_function(SOURCE, "paged_decode_attention_launch",
                           _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_phys.data_ptr(), v_phys.data_ptr(),
             block_tbl.data_ptr(), positions.data_ptr(), out.data_ptr(),
             ws.data_ptr(), B, Hq, Hkv, bs, mb, hd, int(window),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(SOURCE, "paged_decode_attention", err)
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0

__all__ = ["decode_attention", "paged_decode_attention",
           "decode_attention_ref", "paged_decode_attention_ref",
           "SPLIT_KEYS", "SplitPlan", "live_splits", "split_plan",
           "visible_keys", "workspace_floats"]
