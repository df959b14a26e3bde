"""AdamW, the cosine schedule and the global gradient norm: the port of
``repro/training/optimizer.py``.

Parameters, gradients and moments are trees of tensors
(:mod:`repro_torch.core.tree`).  The moments are f32; the update is
computed in f32 and cast back to the parameter's dtype (no f32 master
copy: bf16 weights stay bf16, as in the reference).  ``skip`` (a bool
device scalar, the NaN / Inf guard) freezes parameters, moments and the
step counter without leaving the device.  In the train step every leaf
carries the ranks of a virtual mesh on its leading axis, so the norm's
sum over the whole leaf is the reference's local sum and psum in one;
``repl_factors`` divides out the ranks that hold the same copy.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.tree import tree_items, tree_leaves, tree_map


def adamw_init(params) -> Dict[str, Any]:
    """Zero f32 moments shaped as ``params`` and a step counter of 0
    (int32 scalar on the parameters' device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_grad_norm(grads, repl_factors=None) -> torch.Tensor:
    """L2 norm of the gradient tree, an f32 device scalar: each leaf's
    square-sum divided by its replication factor (a matching tree of ints,
    or None for 1 everywhere), so every logical element counts once."""
    sq = None
    repl = dict(tree_items(repl_factors)) if repl_factors is not None \
        else {}
    for path, g in tree_items(grads):
        s = torch.sum(torch.square(g.float())) / float(repl.get(path, 1))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1,
                 grad_scale=None, skip: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step, written into ``params`` and the moments leaf by
    leaf (no second copy of the model or its moments is held) ->
    (params, opt_state), the same trees.  ``skip`` (bool scalar) leaves
    parameters, moments and ``step`` as they were."""
    step0 = opt_state["step"]
    dev = step0.device
    inc = torch.ones_like(step0) if skip is None \
        else torch.where(skip, 0, 1).to(step0.dtype)
    step = step0 + inc
    t = torch.clamp(step.float(), min=1.0)
    bc1 = 1.0 - torch.pow(_f32(b1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(b2, dev), t)
    lr = _f32(lr, dev)

    def upd(p, g, m, v):
        # the reference's expressions, their products and sums in place on
        # fresh temporaries: a handful of leaf-sized buffers where each
        # operation would take one, the same roundings
        gf = g.float()
        if grad_scale is not None:
            gf = gf * grad_scale
        m_new = b1 * m + (1.0 - b1) * gf
        v_new = torch.square(gf).mul_(1.0 - b2).add_(b2 * v)
        delta = (m_new / bc1).div_((v_new / bc2).sqrt_().add_(eps)) \
            .add_(wd * p.float())
        p_new = delta.mul_(lr).neg_().add_(p.float()).to(p.dtype)
        for old, new in ((p, p_new), (m, m_new), (v, v_new)):
            if skip is None:
                old.copy_(new)
            else:
                torch.where(skip, old, new, out=old)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"] = step
    return params, opt_state


def cosine_lr(step: torch.Tensor, *, base_lr: float, warmup: int,
              total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``: an f32 device scalar."""
    dev = step.device
    t = step.float()
    warm = base_lr * t / _f32(max(warmup, 1), dev)
    prog = torch.clamp((t - warmup) / _f32(max(total - warmup, 1), dev),
                       0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)


__all__ = ["adamw_init", "adamw_update", "cosine_lr", "global_grad_norm"]
