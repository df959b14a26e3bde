"""Selective-state-space (Mamba-style) mixer of the hybrid family over the
virtual mesh (the port of ``repro/models/ssm.py``).

Parameters and activations carry the leading rank axis of the port's
layers (``layers.py``): a group ``p`` holds (R, *local) tensors, h is
(R, B, T, D).  x, z and dt are projected d_inner-sharded, B and C are tiny
and computed replicated (``w_bc``), and the output projection ``w_out`` is
row-sharded, so the mixer returns a TP-partial output like every other
mixer.  The sequence recurrence per channel c and state s,

    h_t = exp(A dt_t) h_{t-1} + (dt_t x_t) B_t
    y_t = C_t . h_t + D_skip x_t,

runs in kernel 9 (``kernels.ssm_scan``) for full sequences and for the
one-token decode step alike (the reference evaluates the first with
``lax.associative_scan`` and the second in jnp), the ranks folded into the
sequences, each rank's A one group of the kernel's grouped operand.  The
decode step updates the cache's ``ssm`` state in place.

The causal depthwise conv is rounded as the reference rounds it: in
prefill its K taps are summed one by one in the activation dtype
(``_causal_conv``), in decode the history is contracted in one f32 sum
rounded once (the reference's ``einsum``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssm_scan
from .common import ModelConfig, dense_init
from .layers import _fold, per_rank, rank_matmul

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def init_ssm(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    """The mixer's group in the global layout, the reference's shapes and
    scales, drawn on ``gen``'s device: A = -[1..s] on every channel (S4D
    real, stored as its log), ``dt_bias``, ``A_log`` and ``D_skip`` f32."""
    d, di, s, dt = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtype
    dev = gen.device
    a = torch.arange(1, s + 1, dtype=torch.float32, device=dev)
    return {
        "w_x": dense_init(gen, (d, di), d, dt),
        "w_z": dense_init(gen, (d, di), d, dt),
        "w_bc": dense_init(gen, (d, 2 * s), d, dt),
        "w_dt": dense_init(gen, (d, di), d, dt),
        "dt_bias": torch.zeros(di, dtype=torch.float32, device=dev),
        "conv_w": dense_init(gen, (cfg.d_conv, di), cfg.d_conv, dt),
        "conv_b": torch.zeros(di, dtype=dt, device=dev),
        "A_log": torch.log(a).repeat(di, 1),
        "D_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (di, d), di, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, x (R, B, T, C), w (R, K, C), b (R, C);
    ``init_state`` (R, B, K-1, C) is the prepended history (zeros without
    it).  The taps are summed one by one in x's dtype."""
    K, T = w.shape[1], x.shape[2]
    if init_state is None:
        init_state = x.new_zeros((*x.shape[:2], K - 1, x.shape[-1]))
    xp = torch.cat([init_state.to(x.dtype), x], dim=2)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, :, i:i + T] * per_rank(w[:, i], x)
    return out + per_rank(b, x)


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """The conv's output at the newest position of ``hist`` (R, B, K, C):
    the taps contracted in one f32 sum rounded once to hist's dtype (the
    reference's decode ``einsum``), plus b (R, C)."""
    return (hist.float() * w[:, None].float()).sum(dim=2).to(hist.dtype) \
        + b[:, None]


def _ssd_inputs(p: Params, h: torch.Tensor):
    """The projections of h (R, B, T, D): x, z (R, B, T, Ci) in h's dtype,
    bc (R, B, T, 2 s) f32, dt = softplus(h w_dt + dt_bias) (R, B, T, Ci)
    f32."""
    x = rank_matmul(h, p["w_x"])
    z = rank_matmul(h, p["w_z"])
    bc = rank_matmul(h, p["w_bc"]).float()
    pre = rank_matmul(h, p["w_dt"]).float()
    dt = F.softplus(pre + per_rank(p["dt_bias"], pre))
    return x, z, bc, dt


def _scan_out(p: Params, h: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
              bc: torch.Tensor, dt: torch.Tensor, s: int,
              h0: Optional[torch.Tensor], h_out: Optional[torch.Tensor]):
    """Kernel 9 over the conv output x (R, B, T, Ci), B and C read in place
    as the two halves of ``bc``; then the skip, the silu(z) gate in f32,
    the cast to h's dtype and the row-sharded output projection.  Returns
    (the TP-partial output (R, B, T, D), the final state (R*B, Ci, s))."""
    xf = x.float()
    y, hs = ssm_scan(_fold(xf), _fold(dt), _fold(bc[..., :s]),
                     _fold(bc[..., s:]), -torch.exp(p["A_log"]), h0,
                     h_out=h_out)
    y = y.reshape(xf.shape) + per_rank(p["D_skip"], xf) * xf
    y = (y * F.silu(z.float())).to(h.dtype)
    return rank_matmul(y, p["w_out"]), hs


def ssm_mixer(p: Params, h: torch.Tensor, cfg: ModelConfig,
              state: Optional[State] = None, return_state: bool = False):
    """Full-sequence selective scan, h (R, B, T, D).  Returns the TP-partial
    output (R, B, T, D) and, with ``return_state``, {"conv" (R, B, K-1, Ci)
    in h's dtype (the last K-1 pre-conv inputs, zero-padded in front when
    the prompt is shorter), "ssm" (R*B, Ci, s) f32}.  ``state`` (the same
    leaves) seeds the conv history and the recurrence."""
    x_in, z, bc, dt = _ssd_inputs(p, h)
    conv0 = None if state is None else state["conv"]
    x = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], conv0))
    out, hs = _scan_out(p, h, x, z, bc, dt, cfg.ssm_state,
                        None if state is None else state["ssm"], None)
    if not return_state:
        return out
    K = cfg.d_conv
    hist = x_in.new_zeros((*x_in.shape[:2], K - 1, x_in.shape[-1])) \
        if conv0 is None else conv0.to(x_in.dtype)
    return out, {"conv": torch.cat([hist, x_in], dim=2)[:, :, -(K - 1):],
                 "ssm": hs}


def ssm_step(p: Params, h: torch.Tensor, state: State, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, State]:
    """Single-token decode step, h (R, B, 1, D); ``state`` {"conv" (R, B,
    K-1, Ci), "ssm" (R*B, Ci, s)}.  The conv contracts the history with the
    new input in one f32 sum; kernel 9 runs at T = 1 with ``state["ssm"]``
    updated in place.  Returns the TP-partial output and {"conv" (the new
    history), "ssm"}."""
    x, z, bc, dt = _ssd_inputs(p, h)
    hist = torch.cat([state["conv"].to(x.dtype), x], dim=2)   # (R, B, K, Ci)
    xc = F.silu(_conv_step(hist, p["conv_w"], p["conv_b"]))[:, :, None]
    out, _ = _scan_out(p, h, xc, z, bc, dt, cfg.ssm_state, state["ssm"],
                       state["ssm"])
    return out, {"conv": hist[:, :, 1:], "ssm": state["ssm"]}


def init_ssm_state(cfg: ModelConfig, batch: int, d_inner_local: int, *,
                   device, dtype: torch.dtype = torch.bfloat16) -> State:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner_local),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner_local, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


__all__ = ["init_ssm", "ssm_mixer", "ssm_step", "init_ssm_state"]
