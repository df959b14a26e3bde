"""Shared model-definition machinery: configs, init helpers, and the GQA
head-padding planner (a copy of ``repro/models/common.py`` in PyTorch terms;
only ``dtype`` changes type, from a JAX dtype to a ``torch.dtype``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba-style; the hybrid family's mixer)
    ssm_state: int = 0
    d_inner: int = 0
    d_conv: int = 4
    dt_rank: int = 0
    # RWKV6
    rwkv_head_dim: int = 64
    decay_lora: int = 64
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 1.0e4
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    norm_eps: float = 1.0e-5
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.family != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
                f"{self.name}: q heads must be a multiple of kv heads"

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count of the dense, MoE, ssm (RWKV6) and
        hybrid families.  The ssm count is every leaf of the model, the
        time-mix output projection ``w_o`` included, which the reference's
        count leaves out (ROADMAP §3).  The hybrid count is every leaf too:
        the mamba branch's full (D, d_inner) ``w_dt`` and its (D, 2 s)
        ``w_bc``, where the reference's count assumes a low-rank
        ``dt_rank`` projection that its ``init_ssm`` does not build, plus
        ``beta`` and the norms (ROADMAP §3)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        if self.attn_free:
            # time-mix: r/k/v/g/o (D, D), decay LoRA, 5 shift mixes, w0, u
            # and the group norm; channel-mix: wk, wv, wr, 2 shift mixes;
            # the two block norms; the final norm
            per_layer = 5 * d * d + 2 * d * self.decay_lora + 9 * d \
                + 2 * d * f + d * d + 2 * d + 2 * d
            return v * d * (1 if self.tie_embeddings else 2) \
                + L * per_layer + d
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        per_layer = d * (hq + 2 * hkv) + hq * d
        if self.family == "hybrid":
            di, s, k = self.d_inner, self.ssm_state, self.d_conv
            # w_x, w_z, w_dt, w_out; w_bc; conv_w; dt_bias, conv_b, D_skip;
            # A_log; the MLP; beta and the two block norms; the final norm
            per_layer += 4 * d * di + 2 * d * s + k * di + 3 * di + di * s \
                + 3 * d * f + 2 + 2 * d
            return v * d * (1 if self.tie_embeddings else 2) \
                + L * per_layer + d
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.d_ff_expert
        else:
            per_layer += (3 if self.act == "swiglu" else 2) * d * f
        return v * d * (1 if self.tie_embeddings else 2) + L * per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.d_ff_expert
        return self.param_count() - inactive


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GQAPlan:
    """Slot layout making an arbitrary (n_q, n_kv) GQA TP-shardable.

    Each of ``tp`` devices gets ``u`` kv slots and ``u*g`` q slots; q slot
    ``s*g + j`` (j < g) attends to kv slot ``s``, which is the ``h // g``
    mapping the attention kernels use.  Dead slots (map -1) carry zero
    weights; at tp=1 there are none (g = n_q / n_kv), at tp > 1 there can
    be (``plan_gqa(6, 2, 4)`` has 2 dead q slots).
    """

    tp: int
    n_q: int
    n_kv: int
    g: int                 # q slots per kv slot
    u: int                 # kv slots per device
    q_map: Tuple[int, ...]   # len tp*u*g, original q-head idx or -1
    kv_map: Tuple[int, ...]  # len tp*u, original kv-head idx or -1

    @property
    def q_slots_local(self) -> int:
        return self.u * self.g

    def q_mask(self) -> np.ndarray:
        """1.0 for live q slots, 0.0 for dead ones (len q_slots)."""
        return (np.asarray(self.q_map) >= 0).astype(np.float32)


def plan_gqa(n_q: int, n_kv: int, tp: int) -> GQAPlan:
    q_per_kv = n_q // n_kv
    assert n_q == n_kv * q_per_kv
    best = None
    for g in range(1, q_per_kv + 1):
        units = n_kv * math.ceil(q_per_kv / g)
        u = math.ceil(units / tp)
        key = (tp * u * g, tp * u)
        if best is None or key < best[0]:
            best = (key, g, u)
    _, g, u = best
    q_map = [-1] * (tp * u * g)
    kv_map = [-1] * (tp * u)
    units = []
    for kv in range(n_kv):
        qs = list(range(kv * q_per_kv, (kv + 1) * q_per_kv))
        for c in range(0, len(qs), g):
            units.append((kv, qs[c:c + g]))
    assert len(units) <= tp * u
    for j, (kv, qs) in enumerate(units):
        dev, slot = divmod(j, u)
        kv_map[dev * u + slot] = kv
        for jj, q in enumerate(qs):
            q_map[(dev * u + slot) * g + jj] = q
    return GQAPlan(tp=tp, n_q=n_q, n_kv=n_kv, g=g, u=u,
                   q_map=tuple(q_map), kv_map=tuple(kv_map))


def place_heads(w: torch.Tensor, head_map, dim: int = 0) -> torch.Tensor:
    """Scatter per-head weights into a padded slot layout: ``w`` has the
    original head count along ``dim``; the result has ``len(head_map)``
    slots there, dead slots (map -1) zero."""
    idx = torch.as_tensor(head_map, dtype=torch.long, device=w.device)
    w = w.movedim(dim, 0)
    live = (idx >= 0).reshape((-1,) + (1,) * (w.dim() - 1))
    out = torch.where(live, w[idx.clamp(min=0)], torch.zeros((), dtype=w.dtype,
                                                            device=w.device))
    return out.movedim(0, dim)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in float32 on ``gen``'s device."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


__all__ = ["ModelConfig", "GQAPlan", "plan_gqa", "place_heads", "pad_to",
           "dense_init", "FAMILIES"]
