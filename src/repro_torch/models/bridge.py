"""Parameter bridge from the JAX package to the port.

The JAX ``init_params`` pytree, with its leaves turned into numpy arrays
by the caller (``jax.tree.map(np.asarray, params)``), becomes a
:class:`~repro_torch.models.transformer.DenseLM`: at tp=1 from
``init_params(key, make_plan(cfg, 1))``, and over a virtual mesh from the
tp=N tree ``init_params(key, make_plan(cfg, N))``, cut into the mesh's N
rank shards as the reference's ``param_specs`` cut it.  Nothing here
imports JAX: the tree is plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .common import ModelConfig
from .transformer import DenseLM, from_global


def _tensor(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    # A JAX bf16 array arrives as an ml_dtypes bfloat16 numpy array, which
    # torch.from_numpy rejects; the trip through float32 is exact.
    return torch.tensor(np.asarray(a).astype(np.float32),
                        device=device).to(dtype)


# Leaves the reference keeps in f32 whatever the model's dtype: a MoE
# router (rounding it would move the top-k choice), the RWKV6 time-mix's
# base decay ``w0`` and bonus ``u``, and the hybrid family's mamba
# ``A_log``, ``D_skip`` and ``dt_bias`` and its mix ``beta``.  No other
# family has a leaf of these names.
_F32_LEAVES = ("router", "w0", "u", "A_log", "D_skip", "dt_bias", "beta")


def _leaf(name: str, a: Any, dtype, device, layer=None) -> torch.Tensor:
    """One leaf (its ``layer``-th slice when given) in ``dtype``, or f32
    when ``name`` is one of ``_F32_LEAVES``."""
    return _tensor(a if layer is None else np.asarray(a)[layer],
                   torch.float32 if name in _F32_LEAVES else dtype, device)


def _group(tree: Mapping[str, Any], dtype, device, layer=None):
    """A group's leaves in ``dtype``, except ``_F32_LEAVES``."""
    return {k: _leaf(k, a, dtype, device, layer) for k, a in tree.items()}


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device, mesh=None) -> DenseLM:
    """tree: {"embed": {"tok", "head"}, "blocks": {"ln1", "attn", "ln2",
    and "mlp" or (MoE) "moe": {"router", "wg", "wu", "wd"}}, for the
    hybrid family {"ln1", "attn", "ssm", "beta" (a bare leaf), "ln2",
    "mlp"}, or for the ssm family {"ln1", "tm", "ln2", "cm"}, with every
    leaf stacked on a leading layer axis, "final_norm"}, in the global
    layout of the plan at tp = the mesh's size (1 without a mesh).  Leaves
    are cast to ``cfg.dtype`` on ``device`` (``_F32_LEAVES`` kept f32),
    layouts kept, and cut over the mesh's ranks: every leaf becomes
    (R, *local)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP item 10")
    dt = cfg.dtype
    blocks = tree["blocks"]
    if cfg.attn_free:
        groups = ("ln1", "tm", "ln2", "cm")
    elif cfg.family == "hybrid":
        groups = ("ln1", "attn", "ssm", "beta", "ln2", "mlp")
    else:
        groups = ("ln1", "attn", "ln2", "moe" if cfg.is_moe else "mlp")
    per_layer = [{name: _group(blocks[name], dt, device, layer=i)
                  if isinstance(blocks[name], Mapping)
                  else _leaf(name, blocks[name], dt, device, layer=i)
                  for name in groups}
                 for i in range(cfg.n_layers)]
    return from_global({"embed": _group(tree["embed"], dt, device),
                        "blocks": per_layer,
                        "final_norm": _group(tree["final_norm"], dt, device)},
                       mesh)


__all__ = ["params_from_numpy"]
