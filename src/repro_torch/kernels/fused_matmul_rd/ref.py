"""Plain PyTorch version of the fused GEMM + recursive-doubling kernel: the
function ``repro/kernels/rd_allreduce/fused_matmul.py::fused_matmul_rd_call``
computes (before its caller's fast-axis sum), as ``rank_matmul`` then
``rd_all_reduce_ref``.  It is the CPU path of the wrapper and the oracle
the kernel is held against on the card."""
from __future__ import annotations

import torch

from ..rd_allreduce.ref import rd_all_reduce_ref


def collective_matmul_rd_ref(x: torch.Tensor, w: torch.Tensor, pods: int, *,
                             n_chunks: int = 1) -> torch.Tensor:
    """x (R, M, K) @ w (R, K, N) per rank, in f32 rounded once to the
    operand type, then summed over the slow axis by recursive doubling:
    (R, M, N).  ``n_chunks`` splits the kernel's columns into blocks and
    never changes the result; it is accepted for the signature only."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks={n_chunks} must be >= 1")
    y = torch.bmm(x.float(), w.float()).to(x.dtype)
    return rd_all_reduce_ref(y, pods)


__all__ = ["collective_matmul_rd_ref"]
