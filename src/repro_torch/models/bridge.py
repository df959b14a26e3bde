"""Parameter bridge between the JAX package and the port.

The JAX ``init_params`` pytree, with its leaves turned into numpy arrays
by the caller (``jax.tree.map(np.asarray, params)``), becomes a
:class:`~repro_torch.models.transformer.DenseLM`: at tp=1 from
``init_params(key, make_plan(cfg, 1))``, and over a virtual mesh from the
tp=N tree ``init_params(key, make_plan(cfg, N))``, cut into the mesh's N
rank shards as the reference's ``param_specs`` cut it; and back
(:func:`params_to_numpy`).  :func:`stack_layers` / :func:`unstack_layers`
move a global tree between the port's per-layer list and the reference's
leading layer axis (the checkpoints' layout).  Nothing here imports JAX:
the tree is plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map
from .common import ModelConfig
from .transformer import DenseLM, from_global, to_global


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


def _leaf(name: str, a: Any, dtype, device, layer=None):
    """One leaf (its ``layer``-th slice when given) in ``dtype``, or f32
    when ``name`` is one of ``_F32_LEAVES``.  A quantized leaf of the
    reference's ``quantize_params`` ({"q": int8, "s": bf16}) keeps its
    types."""
    if isinstance(a, Mapping) and set(a) == {"q", "s"}:
        q = np.asarray(a["q"] if layer is None else np.asarray(a["q"])[layer])
        return {"q": torch.tensor(q.astype(np.int8), device=device),
                "s": _leaf(name, a["s"], torch.bfloat16, device, layer)
                .to(torch.bfloat16)}
    return _tensor(a if layer is None else np.asarray(a)[layer],
                   torch.float32 if name in _F32_LEAVES else dtype, device)


def _group(tree: Mapping[str, Any], dtype, device, layer=None):
    """A group's leaves in ``dtype``, except ``_F32_LEAVES``."""
    return {k: _leaf(k, a, dtype, device, layer) for k, a in tree.items()}


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device, mesh=None) -> DenseLM:
    """tree: {"embed": {"tok", "head"}, "blocks": {"ln1", "attn" (with
    "bq"/"bk"/"bv" under ``qkv_bias``), "ln2",
    and "mlp" (or the gelu MLP's "w1", "b1", "w2") or (MoE) "moe":
    {"router", "wg", "wu", "wd"}}, for the hybrid family {"ln1", "attn",
    "ssm", "beta" (a bare leaf), "ln2", "mlp"}, for the encoder-decoder
    {"ln1", "attn", "ln_x", "xattn", "ln2", "mlp"} with "enc_blocks"
    ({"ln1", "attn", "ln2", "mlp"}) and "enc_norm" beside them, or for
    the ssm family {"ln1", "tm", "ln2", "cm"}, with every leaf of a
    blocks group stacked on a leading layer axis (a layernorm's "b"
    beside its "w"), "final_norm"}, in the global
    layout of the plan at tp = the mesh's size (1 without a mesh).  Leaves
    are cast to ``cfg.dtype`` on ``device`` (``_F32_LEAVES`` kept f32),
    layouts kept, and cut over the mesh's ranks: every leaf becomes
    (R, *local).  The blocks of the reference's ``quantize_params`` tree
    come across as {"q", "s"} nodes (int8 and bf16)."""
    dt = cfg.dtype
    if cfg.attn_free:
        groups = ("ln1", "tm", "ln2", "cm")
    elif cfg.family == "hybrid":
        groups = ("ln1", "attn", "ssm", "beta", "ln2", "mlp")
    else:
        groups = ("ln1", "attn", "ln2", "moe" if cfg.is_moe else "mlp")
    if cfg.enc_layers:
        groups += ("ln_x", "xattn")

    def layers(blocks, names, n):
        return [{name: _group(blocks[name], dt, device, layer=i)
                 if isinstance(blocks[name], Mapping)
                 else _leaf(name, blocks[name], dt, device, layer=i)
                 for name in names} for i in range(n)]

    out = {"embed": _group(tree["embed"], dt, device),
           "blocks": layers(tree["blocks"], groups, cfg.n_layers),
           "final_norm": _group(tree["final_norm"], dt, device)}
    if cfg.enc_layers:
        out["enc_blocks"] = layers(tree["enc_blocks"],
                                   ("ln1", "attn", "ln2", "mlp"),
                                   cfg.enc_layers)
        out["enc_norm"] = _group(tree["enc_norm"], dt, device)
    return from_global(out, mesh)


_LAYER_LISTS = ("blocks", "enc_blocks")


def stack_layers(tree: Mapping[str, Any]) -> dict:
    """A global tree of the port's layout (``transformer.to_global``:
    "blocks" a list of per-layer groups) in the reference's: every leaf of
    a blocks group stacked on a leading layer axis."""
    return {k: tree_map(lambda *ls: torch.stack(ls), *v)
            if k in _LAYER_LISTS else v for k, v in tree.items()}


def unstack_layers(tree: Mapping[str, Any], dim: int = 0) -> dict:
    """The inverse of :func:`stack_layers`, the layer axis at ``dim`` of
    every blocks leaf (1 behind a leading rank axis): views, one group a
    layer."""
    def layers(group):
        n = tree_leaves(group)[0].shape[dim]
        return [tree_map(lambda t: t.select(dim, i), group)
                for i in range(n)]

    return {k: layers(v) if k in _LAYER_LISTS else v
            for k, v in tree.items()}


def params_to_numpy(model: DenseLM, mesh=None) -> dict:
    """The inverse of :func:`params_from_numpy`: the model as the
    reference's tree of numpy arrays (the global layout of its plan,
    blocks on a leading layer axis), f32 copies (bf16 values are exact in
    f32)."""
    return tree_map(lambda t: t.float().cpu().numpy(),
                    stack_layers(to_global(model, mesh)))


__all__ = ["params_from_numpy", "params_to_numpy", "stack_layers",
           "unstack_layers"]
