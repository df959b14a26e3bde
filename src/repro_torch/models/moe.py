"""Mixture-of-Experts FFN with expert parallelism over the virtual mesh:
the port of ``repro/models/moe.py``.

Two execution paths, as in the reference (the paper's Sec. 5.2.4 TP x EP
deployment):

* ``dispatch`` (prefill): sort-based capacity dispatch and the EP
  all-to-all.  Each rank routes its own tokens to the ranks owning their
  experts; capacity overflow drops (token, k) pairs, and the Switch-style
  load-balancing loss comes back as ``aux``.
* ``dense`` (decode): every rank runs its local experts on *all* tokens,
  masks them by the router's top-k gates, and returns a TP-partial sum
  that the caller completes with ``tp_all_reduce``, the paper's
  collective.

Tensors carry the mesh's rank axis first (``core/mesh.py``): tokens
(R, B, S, D), the router (R, D, E) f32 replicated, the experts
(R, E_loc, D, F) / (R, E_loc, F, D) with E_loc = E / R, rank r holding
experts r E_loc onwards.  Every expert FFN of either path is one launch of
the grouped expert FFN kernel for all ranks (:mod:`repro_torch.kernels.
moe_gemm`); the decode path hands it each rank's token block once, shared
by that rank's E_loc experts.

Determinism: the sort is stable (JAX's argsort is; torch's default is
not, and the order decides which pairs overflow), the capacity buffer is
filled by an accumulating scatter (dropped pairs add zeros at (0, cap-1),
as the reference's ``.at[].add``), and each token's K contributions are
summed in k order, not by an atomic scatter-add, so a run repeats itself
bit for bit on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import hierarchical as hier
from ..core.pcontext import ParallelCtx
from ..kernels import moe_expert_ffn
from .common import ModelConfig, dense_init

Params = Mapping[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Experts in the global layout (E, ...), cut on the expert axis by
    ``parallel/sharding.py``; the router stays f32 (the reference's
    ``dense_init(..., jnp.float32)``)."""
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    return {"router": dense_init(gen, (d, e), d, torch.float32),
            "wg": dense_init(gen, (e, d, fe), d, cfg.dtype),
            "wu": dense_init(gen, (e, d, fe), d, cfg.dtype),
            "wd": dense_init(gen, (e, fe, d), fe, cfg.dtype)}


def _router(p: Params, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d (R, T, D) -> gates (R, T, K) normalised, idx (R, T, K), probs
    (R, T, E); the logits in f32."""
    logits = torch.bmm(x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def aux_load_balance(probs: torch.Tensor, idx: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing loss E * sum_e f_e * p_e (times K), one
    per rank: (R,)."""
    e = cfg.n_experts
    f = F.one_hot(idx, e).float().mean(dim=(1, 2))
    pbar = probs.mean(dim=1)
    return e * (f * pbar).sum(-1) * cfg.top_k


def _expert_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (R, n, C, D), n = E_loc token blocks a rank (one per local expert)
    or 1 (a block its E_loc experts share) -> (R, E_loc, C, D): batched
    gated-SiLU experts, one kernel launch for all ranks."""
    R, _, C, D = x.shape
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    e_loc = wg.shape[1]
    out = moe_expert_ffn(x.reshape(-1, C, D), wg.reshape(R * e_loc, D, -1),
                         wu.reshape(R * e_loc, D, -1),
                         wd.reshape(R * e_loc, -1, D))
    return out.reshape(R, e_loc, C, D)


def moe_ffn_dispatch(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     ctx: ParallelCtx, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch with the EP all-to-all.

    x: (R, B, S, D), each rank's own tokens.  Returns (out (R, B, S, D),
    aux (R,))."""
    R, B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    ep = hier.ep_size(ctx, mesh)
    E_loc = E // ep
    x2 = x.reshape(R, T, D)
    gates, idx, probs = _router(p, x2, cfg)
    aux = aux_load_balance(probs, idx, cfg)

    cap = max(int(math.ceil(T * K / E * cfg.capacity_factor)), 4)

    # (token, k) pairs sorted by expert, stably: pairs of one expert keep
    # their token order, the first ``cap`` of them are kept
    e_flat = idx.reshape(R, T * K)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_s = e_flat.gather(1, order)
    t_s = order // K
    g_s = gates.reshape(R, T * K).gather(1, order)
    experts = torch.arange(E, device=x.device).expand(R, E).contiguous()
    starts = torch.searchsorted(e_s, experts, side="left")
    pos = torch.arange(T * K, device=x.device) - starts.gather(1, e_s)
    keep = pos < cap

    # the (E, cap, D) send buffer of every rank
    rr = torch.arange(R, device=x.device)[:, None].expand(R, T * K)
    be = torch.where(keep, e_s, 0)
    bp = torch.where(keep, pos, cap - 1)
    vals = torch.where(keep[..., None], x2[rr, torch.where(keep, t_s, 0)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((R, E, cap, D), dtype=x.dtype, device=x.device)
    buf.index_put_((rr, be, bp), vals, accumulate=True)
    gbuf = torch.zeros((R, E, cap), dtype=torch.float32, device=x.device)
    gbuf.index_put_((rr, be, bp), torch.where(keep, g_s, 0.0),
                    accumulate=True)

    if ep > 1:
        # expert block i to rank i; regroup what arrived by local expert:
        # (ep, E_loc, cap, D) -> (E_loc, ep * cap, D)
        buf = hier.ep_all_to_all(buf.reshape(R, ep, E_loc * cap, D), ctx,
                                 mesh)
        buf = buf.reshape(R, ep, E_loc, cap, D).transpose(1, 2) \
            .reshape(R, E_loc, ep * cap, D)
    else:
        buf = buf.reshape(R, E_loc, cap, D)

    out_buf = _expert_ffn(p, buf)

    if ep > 1:
        out_buf = out_buf.reshape(R, E_loc, ep, cap, D).transpose(1, 2) \
            .reshape(R, ep, E_loc * cap, D)
        out_buf = hier.ep_all_to_all(out_buf, ctx, mesh)
    out_buf = out_buf.reshape(R, E, cap, D)

    # combine: each kept pair's output, weighted by its gate, back in
    # (token, k) order; a token's K contributions summed in k order
    contrib = out_buf[rr, be, bp] \
        * gbuf[rr, be, bp][..., None].to(out_buf.dtype)
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=contrib.dtype,
                                      device=x.device))
    inv = torch.argsort(order, dim=-1)
    contrib = contrib.gather(1, inv[..., None].expand(R, T * K, D))
    out = contrib.float().reshape(R, T, K, D).sum(2)
    return out.reshape(R, B, S, D).to(x.dtype), aux


def moe_ffn_dense(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  ctx: ParallelCtx, mesh=None) -> torch.Tensor:
    """Decode path: all local experts on all tokens, gate-masked.

    x: (R, B, S, D), the same tokens on every rank.  Returns the TP-partial
    combine (R, B, S, D); the caller's ``tp_all_reduce`` completes it."""
    R, B, S, D = x.shape
    T = B * S
    E = cfg.n_experts
    ep = hier.ep_size(ctx, mesh)
    E_loc = E // ep
    x2 = x.reshape(R, T, D)
    gates, idx, _ = _router(p, x2, cfg)
    # dense per-token weights of every expert (R, T, E), then each rank's
    # own E_loc columns
    w_full = torch.zeros((R, T, E), dtype=torch.float32, device=x.device) \
        .scatter_(2, idx, gates)
    e0 = hier.ep_rank(ctx, mesh, x.device)
    w_loc = w_full.reshape(R, T, ep, E_loc).gather(
        2, e0.view(R, 1, 1, 1).expand(R, T, 1, E_loc))[:, :, 0]
    ye = _expert_ffn(p, x2[:, None])                   # (R, E_loc, T, D)
    out = torch.einsum("retd,rte->rtd", ye.float(), w_loc)
    return out.reshape(R, B, S, D).to(x.dtype)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx,
            mesh=None, *, decode: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (output, aux_loss_or_None).

    decode=True  -> dense path, output TP-PARTIAL (reduce at the call site).
    decode=False -> dispatch path, output complete (all-to-all combined).
    """
    if decode:
        return moe_ffn_dense(p, x, cfg, ctx, mesh), None
    return moe_ffn_dispatch(p, x, cfg, ctx, mesh)


__all__ = ["init_moe", "moe_ffn", "moe_ffn_dispatch", "moe_ffn_dense",
           "aux_load_balance"]
