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
# router (rounding it would move the top-k choice) and the RWKV6 time-mix's
# base decay ``w0`` and bonus ``u``.
_F32_LEAVES = ("router", "w0", "u")


def _group(tree: Mapping[str, Any], dtype, device, layer=None):
    """A group's leaves in ``dtype``, except ``_F32_LEAVES``."""
    return {k: _tensor(a if layer is None else np.asarray(a)[layer],
                       torch.float32 if k in _F32_LEAVES else dtype, device)
            for k, a in tree.items()}


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device, mesh=None) -> DenseLM:
    """tree: {"embed": {"tok", "head"}, "blocks": {"ln1", "attn", "ln2",
    and "mlp" or (MoE) "moe": {"router", "wg", "wu", "wd"}}, or for the
    ssm family {"ln1", "tm", "ln2", "cm"}, with every leaf stacked on a
    leading layer axis, "final_norm"}, in the global layout of the plan at
    tp = the mesh's size (1 without a mesh).  Leaves are cast to
    ``cfg.dtype`` on ``device`` (``_F32_LEAVES`` kept f32), layouts kept,
    and cut over the mesh's ranks: every leaf becomes (R, *local)."""
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP item 10")
    dt = cfg.dtype
    blocks = tree["blocks"]
    groups = ("ln1", "tm", "ln2", "cm") if cfg.attn_free else \
        ("ln1", "attn", "ln2", "moe" if cfg.is_moe else "mlp")
    per_layer = [{name: _group(blocks[name], dt, device, layer=i)
                  for name in groups}
                 for i in range(cfg.n_layers)]
    return from_global({"embed": _group(tree["embed"], dt, device),
                        "blocks": per_layer,
                        "final_norm": _group(tree["final_norm"], dt, device)},
                       mesh)


__all__ = ["params_from_numpy"]
