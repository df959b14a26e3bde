"""Weight quantization for serving: the port of ``repro/parallel/quant.py``.

Each block weight ``w`` becomes ``{"q": int8 w, "s": bf16 scale}``: one
scale per index of the leaf's LAST dim, reduced over every other dim of a
layer (``max|w| / 127``, at least 1e-30), as the reference reduces a
stacked leaf over all dims but layer and last.  So ``wq``/``wk``/``wv``
(D, slots, hd) get one scale per ``hd`` index, ``wo`` (slots, hd, D) and
``wd`` (F, D) one per output column, ``wg``/``wu`` (D, F) one per column.
Embeddings, norms and the leaves of ``_SKIP`` stay as they are.  The
quotient ``lf / s`` is IEEE division (eager JAX's; a device division by a
Python scalar would multiply by the reciprocal, so 127 is a tensor here),
so ``q`` and ``s`` are bitwise the reference's.

* :func:`quantize_params` / :func:`quantize_blocks` act on the global
  tree of :func:`~repro_torch.models.transformer.from_global` (per-layer
  groups, no rank axis); the sharding rules cut a ``{q, s}`` node by its
  parent's name and leave the scale's size-1 dims whole.
* :func:`quantize_model` quantizes a built
  :class:`~repro_torch.models.transformer.DenseLM` in place of that: its
  leaves are (R, *local), so a scale that the global reduction takes over
  a TP-cut dim is the max over the ranks too.  The result equals
  quantizing the global tree, then cutting it.
* :func:`dequant_layer` is the reference's per-layer dequantization,
  ``bf16(float(q) * float(s))``; :class:`LayerMap` runs it in the decode
  step for the leaves no ``w8_matmul`` reads, into buffers made once.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

# leaves that stay un-quantized (tiny and/or accuracy-critical)
_SKIP = {"w", "b", "mu", "beta", "u", "w0", "ln_w", "ln_b", "dt_bias",
         "A_log", "D_skip", "conv_b", "router", "bq", "bk", "bv", "b1"}


def is_qs(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "s"}


def _quantize(t: torch.Tensor, across_ranks: bool) -> Dict[str, torch.Tensor]:
    """t (R, *dims) -> {"q": int8 (R, *dims), "s": bf16 (R, 1.., last)}:
    max|t| over every dim but the rank and the last, then (when
    ``across_ranks``) over the ranks."""
    lf = t.float()
    m = lf.abs().amax(dim=tuple(range(1, t.dim() - 1)), keepdim=True)
    if across_ranks:
        m = m.amax(dim=0, keepdim=True).expand_as(m)
    d127 = torch.full((), 127.0, device=t.device)
    s = torch.clamp(m / d127, min=1e-30)
    q = torch.clamp(torch.round(lf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.bfloat16)}


def _quantizes(name: str, t: torch.Tensor, layer_ndim: int) -> bool:
    """The reference's test on a stacked leaf (ndim >= 3 with the layer
    axis), here on one layer's leaf of ``layer_ndim`` dims."""
    return name not in _SKIP and t.dtype in (torch.bfloat16, torch.float32) \
        and layer_ndim >= 2


def quantize_blocks(blocks):
    """Quantize the global per-layer block groups (a list of {group: {name:
    tensor}} or bare tensors): w -> {'q', 's'}."""
    def f(name, t):
        if not isinstance(t, torch.Tensor) or not _quantizes(name, t,
                                                             t.dim()):
            return t
        return {k: v[0] for k, v in _quantize(t[None], False).items()}

    def group(g, gname):
        if isinstance(g, Mapping):
            return {k: f(k, v) for k, v in g.items()}
        return f(gname, g)

    return [{gname: group(g, gname) for gname, g in layer.items()}
            for layer in blocks]


def quantize_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The global tree {"embed", "blocks", "final_norm"} with its blocks
    quantized."""
    out = dict(params)
    out["blocks"] = quantize_blocks(params["blocks"])
    return out


def quantize_model(model):
    """A new DenseLM whose block weights are ``{q, s}`` nodes, each (R,
    *local) as ``from_global`` would cut the quantized global tree; the
    embedding, the norms and an encoder (the reference quantizes the
    decoder's blocks only) are shared with ``model``."""
    from ..models.transformer import Block, DenseLM
    from .sharding import tp_dim

    def leaf(path: Tuple[str, ...], t: torch.Tensor):
        if not _quantizes(path[-1], t, t.dim() - 1):
            return t
        d = tp_dim(path, t.dim() - 1)
        return _quantize(t, d is None or d != t.dim() - 2)

    blocks = []
    for bp in model.blocks:
        groups = {}
        for gname, g in bp.named_children():
            groups[gname] = {k: leaf((gname, k), v) for k, v in g.items()}
        for gname, t in bp.named_parameters(recurse=False):
            groups[gname] = leaf((gname,), t)
        blocks.append(groups)
    out = DenseLM({}, [], {})
    out.embed, out.final_norm = model.embed, model.final_norm
    out.enc_blocks, out.enc_norm = model.enc_blocks, model.enc_norm
    out.blocks = torch.nn.ModuleList(Block(b) for b in blocks)
    return out


def dequant(node: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """{q, s} -> bf16 ``float(q) * float(s)``, the reference's operand."""
    return (node["q"].float() * node["s"].float()).to(torch.bfloat16)


def dequant_layer(tree):
    """Per-layer dequant: every {q, s} node of a (nested) mapping -> its
    bf16 leaf."""
    if is_qs(tree):
        return dequant(tree)
    if isinstance(tree, Mapping):
        return {k: dequant_layer(v) for k, v in tree.items()}
    return tree


class LayerMap:
    """The decode step's per-layer hook under ``weight_quant``: a block
    seen with its {q, s} leaves that ``keep(group, name)`` rejects
    dequantized (``dequant_layer``'s values, in ``dtype``) into one buffer
    per (group, name), allocated at the first call and rewritten for
    every layer, so a captured CUDA graph holds them; the kept leaves stay
    {q, s} for ``w8_matmul``.  Returns a view with the block's group
    attributes."""

    def __init__(self, keep: Callable[[str, str], bool], dtype: torch.dtype):
        self.keep = keep
        self.dtype = dtype
        self._bufs: Dict[Tuple[str, str], torch.Tensor] = {}

    def _leaf(self, gname: str, name: str, v):
        if not is_qs(v) or self.keep(gname, name):
            return v
        buf = self._bufs.get((gname, name))
        if buf is None:
            buf = torch.empty(v["q"].shape, dtype=self.dtype,
                              device=v["q"].device)
            self._bufs[(gname, name)] = buf
        buf.copy_(dequant(v))
        return buf

    def __call__(self, bp) -> SimpleNamespace:
        groups = {gname: {k: self._leaf(gname, k, v) for k, v in g.items()}
                  for gname, g in bp.named_children()}
        return SimpleNamespace(**groups,
                               **dict(bp.named_parameters(recurse=False)))


__all__ = ["quantize_params", "quantize_blocks", "quantize_model",
           "dequant", "dequant_layer", "is_qs", "LayerMap", "_SKIP"]
