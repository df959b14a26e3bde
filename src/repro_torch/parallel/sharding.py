"""Tensor-parallel parameter sharding over the virtual mesh: the port of
the TP rules of ``repro/parallel/sharding.py`` for the dense, MoE, ssm
(RWKV6) and hybrid families.

A leaf's TP dimension is cut into R contiguous pieces, rank r taking piece
r (slow-major, as ``PartitionSpec((slow, fast))`` cuts it), and the pieces
are stacked on a new leading rank axis: (R, *local_shape).  A leaf whose
TP dimension does not divide by R, and a leaf with no TP dimension (the
norms, the MoE router), is replicated on every rank, as ``_leaf_plan``
leaves it.  Under a ``moe`` parent the expert leaves ``wg``/``wu``/``wd``
((E, D, F) / (E, F, D)) are cut on the expert axis instead
(``_MOE_EXPERT_LEAVES``); ``transformer.make_plan`` refuses an expert
count that R does not divide, where the reference would silently
replicate the experts while its MoE layer slices them.  Under an RWKV6
channel-mix parent (``cm``) ``wk`` (D, F) is cut on its columns, ``wv``
(F, D) and ``wr`` (D, D) on their rows, and ``mu`` is replicated: the
attention rule of ``wk`` (the slot axis) would cut it on the wrong axis.
The time-mix's head-sharded leaves are cut on their A axis, ``w_o`` on
its rows; ``w_a`` and the shift mixes ``mu`` are replicated.  The hybrid
family's mamba leaves are cut on d_inner (``A_log`` and ``w_out`` on their
rows); ``w_bc`` and the block's mix ``beta`` are replicated.  No hybrid
leaf name meets a rule written for another family (``w``/``b`` are the
norms').  FSDP is not part of serving here (``fsdp_serve`` is not
ported).

The decode cache follows ``cache_spec``: its head (slot) dimension is
sharded, so each rank holds ``ap.gqa.u`` kv slots
(``transformer.init_cache``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

# leaf name -> TP dimension counted from the end (so a leading stacked-layer
# axis rides along); None = replicated.  Attention slot layouts: wq/wk/wv
# (D, slots, hd) -> -2, wo (slots, hd, D) -> -3.
TP_RULES: Dict[str, Optional[int]] = {
    "tok": -2, "head": -1,
    "wq": -2, "wk": -2, "wv": -2, "wo": -3,
    "bq": -2, "bk": -2, "bv": -2,
    "wg": -1, "wu": -1, "w1": -1, "b1": -1, "wd": -2, "w2": -2,
    "w": None, "b": None,
    "router": None,
    # rwkv time-mix: A (= heads x hd) sharded; w_o row-sharded
    "w_r": -1, "w_k": -1, "w_v": -1, "w_g": -1, "w0": -1, "u": -1,
    "ln_w": -1, "ln_b": -1, "w_a": None, "w_b": -1, "w_o": -2,
    "mu": None,
    # mamba (the hybrid family's ssm group): d_inner-sharded leaves, A_log
    # and w_out cut on their rows; w_bc (B and C) and the mix beta
    # replicated
    "w_x": -1, "w_z": -1, "w_dt": -1, "dt_bias": -1,
    "conv_w": -1, "conv_b": -1, "A_log": -2, "D_skip": -1,
    "w_out": -2, "w_bc": None, "beta": None,
}

# Expert leaves of a MoE layer, cut on their leading expert axis.
_MOE_EXPERT_LEAVES = {"wg", "wu", "wd"}
# An RWKV6 channel-mix: wk (D, F) col, wv (F, D) row, wr (D, D) row.
_CM_RULES: Dict[str, Optional[int]] = {"wk": -1, "wv": -2, "wr": -2,
                                       "mu": None}


def tp_dim(path_names: Sequence[str], ndim: int) -> Optional[int]:
    """The TP dimension of the leaf at ``path_names`` (the names of its
    parents, then its own), or None."""
    name = path_names[-1]
    if "moe" in path_names[:-1] and name in _MOE_EXPERT_LEAVES:
        return ndim - 3
    if "cm" in path_names[:-1]:
        d = _CM_RULES[name]
        return None if d is None else ndim + d
    if name not in TP_RULES:
        raise KeyError(f"no TP rule for param {'/'.join(path_names)}")
    d = TP_RULES[name]
    return None if d is None else ndim + d


def shard_leaf(t: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """(R, ...) pieces of ``t`` along ``dim`` (or R copies); at R = 1 a
    view of ``t``, no copy."""
    if n == 1:
        return t.unsqueeze(0)
    if dim is None or t.shape[dim] % n:
        return t.unsqueeze(0).expand(n, *t.shape).contiguous()
    return torch.stack(torch.chunk(t, n, dim=dim))


def _shard(tree: Any, n: int, path: Tuple[str, ...]) -> Any:
    if isinstance(tree, Mapping):
        return {k: _shard(v, n, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard(v, n, path) for v in tree]
    return shard_leaf(tree, tp_dim(path, tree.dim()), n)


def shard_params(tree: Any, mesh=None) -> Any:
    """Every leaf of a nested dict (or list of per-layer dicts) of
    global-layout tensors cut over the mesh's R ranks and stacked:
    (R, *local).  Without a mesh R = 1 (tp=1)."""
    return _shard(tree, mesh.size if mesh is not None else 1, ())


__all__ = ["TP_RULES", "tp_dim", "shard_leaf", "shard_params"]
