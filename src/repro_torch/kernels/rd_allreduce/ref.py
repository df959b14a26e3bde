"""Plain PyTorch version of the recursive-doubling all-reduce: the port of
``repro/core/hierarchical.py::rd_all_reduce``, the oracle that
``repro/kernels/rd_allreduce/ref.py`` names for the TPU kernel.

The ranks of a virtual mesh are the leading axis of one tensor (rank =
pod * fast + f), so the XOR-peer exchange of step s is an index of that
axis: ``y = y + y[peer]``.
"""
from __future__ import annotations

import torch


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def xor_peers(n: int, stride: int) -> torch.Tensor:
    """Peer of every rank at the step with this stride: ``j ^ stride``
    (``hierarchical._xor_perm`` as an index)."""
    return torch.arange(n) ^ stride


def slow_sum(x: torch.Tensor, pods: int) -> torch.Tensor:
    """``lax.psum`` over the slow axis: x (R, ...) with R = pods * fast;
    every rank gets the sum over the pods of its fast column."""
    y = x.reshape(pods, -1, *x.shape[1:])
    return y.sum(0, keepdim=True).expand_as(y).reshape(x.shape)


def rd_all_reduce_ref(x: torch.Tensor, pods: int, *,
                      n_chunks: int = 1) -> torch.Tensor:
    """x (R, ...) -> the sum over the slow axis, on every rank.

    log2(pods) XOR steps, each adding the peer's whole partial in the
    operand type (f32 math, one rounding, as XLA adds ``y +
    ppermute(y)``).  ``pods == 1`` is the identity and a non-power-of-two
    ``pods`` takes the plain sum, as the reference dispatches.
    ``n_chunks`` splits the exchange in the reference; every element gets
    the same adds in the same order whatever the split, so it does not
    change the result and is accepted for the signature only.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks={n_chunks} must be >= 1")
    if pods == 1:
        return x
    if not is_pow2(pods):
        return slow_sum(x, pods)
    y = x.reshape(pods, -1, *x.shape[1:])
    step = 1
    while step < pods:
        y = y + y[xor_peers(pods, step).to(y.device)]
        step <<= 1
    return y.reshape(x.shape)


__all__ = ["rd_all_reduce_ref", "slow_sum", "is_pow2", "xor_peers"]
