"""RWKV6 ("Finch") blocks over the virtual mesh: time-mix with
data-dependent per-channel decay and the channel-mix FFN (the port of
``repro/models/rwkv.py``).

Parameters and activations carry the leading rank axis of the port's
layers (``layers.py``): a group ``p`` holds (R, *local) tensors, x is
(R, B, T, D).  The heads (A = d_model channels, H = A / hd heads) are
TP-sharded for r/k/v/g, the decay and the recurrent state; ``w_o`` is
row-sharded, so the time-mix returns a TP-partial output.  The channel-mix
returns a *stacked* (value, receptance-logit) partial (R, 2, B, T, D) that
the caller completes with one ``tp_all_reduce`` before the sigmoid gate,
the paper's one collective per sublayer.

The sequence recurrence per head (key dim x value dim state S),

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,

runs in kernel 8 (``kernels.rwkv6_scan``) for full sequences and for the
one-token decode step alike (the reference evaluates the first in a
chunked form and the second in jnp), the ranks folded into the sequences.
The decode step updates the cache's state in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import rwkv6_scan
from .common import ModelConfig, dense_init
from .layers import _fold, per_rank, rank_matmul

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """The time-mix group in the global layout, the reference's shapes and
    scales (attention dim A = d_model), drawn on ``gen``'s device."""
    d, dt = cfg.d_model, cfg.dtype
    hd = cfg.rwkv_head_dim
    dev = gen.device
    w = {name: dense_init(gen, (d, d), d, dt)
         for name in ("w_r", "w_k", "w_v", "w_g")}
    w_a = dense_init(gen, (d, cfg.decay_lora), d, dt)
    w_b = dense_init(gen, (cfg.decay_lora, d), cfg.decay_lora, dt)
    w_o = dense_init(gen, (d, d), d, dt)
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # r,k,v,w,g
        **w,
        "w0": torch.linspace(-6.0, -0.5, hd, device=dev).repeat(d // hd),
        "w_a": w_a, "w_b": w_b,
        "u": torch.zeros(d, dtype=torch.float32, device=dev),
        "ln_w": torch.ones(d, dtype=dt, device=dev),
        "ln_b": torch.zeros(d, dtype=dt, device=dev),
        "w_o": w_o,
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig
                          ) -> Dict[str, torch.Tensor]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "mu": torch.full((2, d), 0.5, dtype=dt, device=gen.device),  # k, r
        "wk": dense_init(gen, (d, f), d, dt),
        "wv": dense_init(gen, (f, d), f, dt),
        "wr": dense_init(gen, (d, d), d, dt),      # row-sharded
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along the sequence of x (R, B, T, D); ``prev`` (R, B, D)
    seeds position 0 (zeros without it)."""
    first = torch.zeros_like(x[:, :, :1]) if prev is None \
        else prev[:, :, None].to(x.dtype)
    return torch.cat([first, x[:, :, :-1]], dim=2)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    """Token-shift interpolation with a per-rank mix row ``mu`` (R, D)."""
    return x + (xs - x) * per_rank(mu, x)


def _group_norm(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm over the value channels.  y: (R, B, T, H, hd) ->
    (R, B, T, A) f32; w, b (R, A)."""
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = (yf - mu).square().mean(dim=-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).flatten(-2)
    return yn * per_rank(w, yn) + per_rank(b, yn)


def _rkvwg(p: Params, x: torch.Tensor, prev: Optional[torch.Tensor],
           hd: int):
    """Receptance, key, value (f32 heads (R, B, T, H, hd)), the gate g
    (x's dtype), the log decay (f32 heads) and the last position of x."""
    xs = _shift(x, prev)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_mix(x, xs, mu[:, i]) for i in range(5))
    r = rank_matmul(xr, p["w_r"])
    k = rank_matmul(xk, p["w_k"])
    v = rank_matmul(xv, p["w_v"])
    g = rank_matmul(xg, p["w_g"])
    # data-dependent decay (the RWKV6 signature feature)
    lora = rank_matmul(torch.tanh(rank_matmul(xw, p["w_a"])),
                       p["w_b"]).float()
    logw = -torch.exp(per_rank(p["w0"], lora) + lora)     # log decay < 0

    def heads(t):
        return t.float().unflatten(-1, (-1, hd))
    return heads(r), heads(k), heads(v), g, heads(logw), x[:, :, -1]


def _time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
              prev: Optional[torch.Tensor], s0: Optional[torch.Tensor],
              s_out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, State]:
    r, k, v, g, logw, last = _rkvwg(p, x, prev, cfg.rwkv_head_dim)
    R, _, _, H, hd = r.shape
    y, s = rwkv6_scan(_fold(r), _fold(k), _fold(v), _fold(logw),
                      p["u"].reshape(R, H, hd), s0, s_out=s_out)
    y = _group_norm(y.reshape(r.shape), p["ln_w"], p["ln_b"])
    y = (y * F.silu(g.float())).to(x.dtype)
    return rank_matmul(y, p["w_o"]), {"shift_tm": last, "wkv": s}


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[State] = None, return_state: bool = False):
    """Full-sequence time-mix, x (R, B, T, D).  Returns the TP-partial
    output (R, B, T, D) and, with ``return_state``, {"shift_tm" (R, B, D),
    "wkv" (R*B, H, hd, hd) f32}.  ``state`` (the same leaves) seeds the
    shift and the recurrence."""
    out, st = _time_mix(p, x, cfg,
                        None if state is None else state["shift_tm"],
                        None if state is None else state["wkv"], None)
    return (out, st) if return_state else out


def rwkv_time_mix_step(p: Params, x: torch.Tensor, state: State,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """Single-token decode step, x (R, B, 1, D): kernel 8 at T = 1 with
    ``state["wkv"]`` updated in place.  Returns the TP-partial output and
    {"shift_tm", "wkv"}."""
    return _time_mix(p, x, cfg, state["shift_tm"], state["wkv"],
                     state["wkv"])


def _own_cols(xr: torch.Tensor, dloc: int) -> torch.Tensor:
    """Rank r's r-th slice of ``dloc`` channels of xr (R, ..., R * dloc):
    the columns that meet rank r's rows of the row-sharded ``wr``."""
    R = xr.shape[0]
    r = torch.arange(R, device=xr.device)
    return xr.reshape(R, -1, R, dloc)[r, :, r].reshape(*xr.shape[:-1], dloc)


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[State] = None,
                     return_state: bool = False):
    """Channel-mix, x (R, B, T, D).  Returns the STACKED TP-partials
    (R, 2, B, T, D), [value, receptance logit], which the caller reduces
    once and gates (``out = sigmoid(r) * v``), and with ``return_state``
    {"shift_cm" (R, B, D)}."""
    prev = None if state is None else state["shift_cm"]
    xs = _shift(x, prev)
    xk = _mix(x, xs, p["mu"][:, 0])
    xr = _mix(x, xs, p["mu"][:, 1])
    kk = torch.square(F.relu(rank_matmul(xk, p["wk"])))
    val = rank_matmul(kk, p["wv"])
    # wr is row-sharded: each rank contracts its own slice of xr with its
    # rows, so the receptance logit is a TP-partial just like ``val``
    dloc = p["wr"].shape[-2]
    xr_loc = xr if dloc == xr.shape[-1] else _own_cols(xr, dloc)
    rlog = rank_matmul(xr_loc, p["wr"])
    stacked = torch.stack([val, rlog.to(val.dtype)], dim=1)
    if return_state:
        return stacked, {"shift_cm": x[:, :, -1]}
    return stacked


def init_rwkv_state(cfg: ModelConfig, batch: int, heads_local: int, *,
                    device, dtype: torch.dtype = torch.bfloat16) -> State:
    hd = cfg.rwkv_head_dim
    return {
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, heads_local, hd, hd), dtype=torch.float32,
                           device=device),
    }


__all__ = ["init_rwkv_time_mix", "init_rwkv_channel_mix", "rwkv_time_mix",
           "rwkv_time_mix_step", "rwkv_channel_mix", "init_rwkv_state"]
