"""Event-driven cluster simulator for multi-node inference performance: the
port of ``repro/inference/simulator.py``.

Per-step times are built from analytic per-device FLOP/byte counts
(roofline: max(compute, memory)) plus collective times from the
alpha-beta models of :mod:`repro_torch.core.comm_model`.  Three modelling
choices carry the paper's findings:

* **Decode GEMM tile floor** (Table 4): GEMM time uses M_eff = max(M, 128)
  -- shrinking the token dimension below the tensor-core tile yields no
  speedup, which is why PP cannot reduce decode matmul time (Obs. 2)
  while TP's K-split can.
* **TP all-reduce per layer**: 2 x AR(B x H) in decode (Sec. 3.5's message
  sizes) priced by the NCCL-best / NVRAR models (Obs. 3 / Sec. 4).
* **Pipeline bubbles**: HP latency uses the (m + p - 1)/m GPipe factor for
  prefill and per-token stage serialization for decode.

The chips are model inputs.  ``A100``, ``GH200`` and ``V5E`` are the
reference's, the peaks of the paper's two systems and of its TPU target
as the reference wrote them; nothing in the port measured them.  ``H100``
is the one card the port runs on: its peaks are the ones
``chip_smoke.py``'s bounds use and its ``efficiency`` and ``hbm_cap`` were
measured on the card by ``chip_smoke.py`` phase 34.  The cost functions
read the port's :class:`~repro_torch.models.common.ModelConfig` field by
field (never ``param_count``), so the numbers equal the reference's for
the same configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core import comm_model as cm
from ..models.common import ModelConfig


# ---------------------------------------------------------------------------
# Hardware
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    flops_bf16: float      # FLOP/s
    hbm_bw: float          # B/s
    hbm_cap: float         # bytes
    gemm_tile_m: int = 128  # M below this yields no GEMM speedup (Table 4)
    efficiency: float = 0.55  # sustained fraction of peak for big GEMMs


A100 = ChipSpec("A100-80G", 312e12, 2.0e12, 80e9)
GH200 = ChipSpec("GH200", 989e12, 4.0e12, 96e9)
V5E = ChipSpec("TPUv5e", 197e12, 0.819e12, 16e9)

# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (nvidia-smi): the dense
# bf16 tensor-core and HBM3 peaks of the data sheet (chip_smoke.py's
# PEAK_FLOPS and HBM_BYTES_PER_S), the memory that
# torch.cuda.get_device_properties(0).total_memory reports, and the
# sustained share of the bf16 peak of one (8, 4096, 4096) x (8, 4096, 4096)
# bmm (1.4114 ms, 779.0 TFLOP/s), both measured by chip_smoke.py phase 34
# on that card (PERF.md).
H100 = ChipSpec("H100-80G", 989e12, 3.35e12, 85017493504,
                efficiency=0.7877)

CHIP_FOR_NET = {"perlmutter": A100, "vista": GH200, "tpu_v5e": V5E}


# ---------------------------------------------------------------------------
# Analytic per-device costs
# ---------------------------------------------------------------------------


def _layer_gemm_flops(cfg: ModelConfig, m_tokens: int, tile_m: int) -> float:
    """Per-layer projection GEMM flops for M tokens with the tile-floor
    effect applied (M_eff)."""
    m_eff = max(m_tokens, tile_m)
    d, hd = cfg.d_model, cfg.head_dim
    qkvo = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * d
    if cfg.is_moe:
        ff = 3 * d * cfg.d_ff_expert * cfg.top_k
    else:
        ff = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return 2.0 * m_eff * (qkvo + ff)


def _layer_attn_flops(cfg: ModelConfig, m_tokens: int, ctx: int) -> float:
    return 4.0 * m_tokens * ctx * cfg.n_heads * cfg.head_dim


def _layer_param_bytes(cfg: ModelConfig, dtype_bytes: int = 2,
                       active_only: bool = True) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    n = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    if cfg.is_moe:
        n += 3 * d * cfg.d_ff_expert * (cfg.top_k if active_only
                                        else cfg.n_experts)
    else:
        n += (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return n * dtype_bytes


def _kv_bytes_per_token_ctx(cfg: ModelConfig, ctx: int,
                            dtype_bytes: int = 2) -> float:
    return 2.0 * ctx * cfg.n_kv_heads * cfg.head_dim * dtype_bytes


# ---------------------------------------------------------------------------
# Collective timing
# ---------------------------------------------------------------------------


def ar_time(msg_bytes: float, *, algo: str, n_nodes: int, g: int,
            net: cm.NetworkSpec) -> float:
    if n_nodes * g <= 1:
        return 0.0
    if n_nodes <= 1:
        # intra-node ring all-reduce over NVLink
        t = 2 * (g - 1) * net.alpha_intra \
            + 2 * (g - 1) / g * msg_bytes / net.beta_intra
        if algo.startswith("nvrar"):
            # NVRAR degenerates to RS+AG with 3-phase launch overhead
            # (the paper's single-node slowdowns, Fig. 6)
            t += 2 * net.alpha_intra
        return t
    if algo == "nccl":
        return cm.nccl_model_best(msg_bytes, n_nodes, g, net)[1]
    if algo == "ring":
        return cm.t_ring_allreduce(msg_bytes, n_nodes, g, net)
    if algo == "tree":
        return cm.t_tree_allreduce(msg_bytes, n_nodes, g, net)
    if algo == "nvrar":
        return cm.t_nvrar(msg_bytes, n_nodes, g, net)
    if algo == "nvrar_halving":
        return cm.t_nvrar_variant(msg_bytes, n_nodes, g, net,
                                  inter="halving")
    raise ValueError(algo)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepBreakdown:
    matmul: float = 0.0
    other: float = 0.0
    comm: float = 0.0
    idle: float = 0.0

    @property
    def total(self) -> float:
        return self.matmul + self.other + self.comm + self.idle

    def add(self, o: "StepBreakdown"):
        self.matmul += o.matmul
        self.other += o.other
        self.comm += o.comm
        self.idle += o.idle


@dataclasses.dataclass
class ClusterSim:
    cfg: ModelConfig
    chip: ChipSpec
    net: cm.NetworkSpec
    n_gpus: int
    scheme: str = "tp"            # "tp" | "hp"
    ar_algo: str = "nccl"         # nccl | ring | tree | nvrar | nvrar_halving
    microbatches: int = 4         # HP prefill microbatching
    straggler_delay: float = 0.0  # per-AR extra latency from one slow node

    def __post_init__(self):
        g = self.net.gpus_per_node
        self.n_nodes = max(1, self.n_gpus // g)
        self.g = min(self.n_gpus, g)
        if self.scheme == "tp":
            self.tp = self.n_gpus
            self.pp = 1
        else:                       # HP: TP within node, PP across nodes
            self.tp = self.g
            self.pp = self.n_nodes

    # -- one forward pass over m tokens with context ctx (per layer group) --
    def _step_time(self, m_tokens: int, ctx: int, *, phase: str,
                   layers: int, with_ar: bool) -> StepBreakdown:
        cfg, chip = self.cfg, self.chip
        bd = StepBreakdown()
        eff = chip.flops_bf16 * chip.efficiency
        gemm_f = _layer_gemm_flops(cfg, m_tokens, chip.gemm_tile_m) / self.tp
        attn_f = _layer_attn_flops(cfg, m_tokens, ctx) / self.tp
        # memory: weights stream once per step; decode adds the KV read
        w_bytes = _layer_param_bytes(cfg) / self.tp
        kv_b = 0.0
        if phase == "decode":
            kv_b = m_tokens * _kv_bytes_per_token_ctx(cfg, ctx) / self.tp
        t_gemm = max(gemm_f / eff, w_bytes / chip.hbm_bw)
        t_attn = max(attn_f / eff, kv_b / chip.hbm_bw)
        bd.matmul += layers * t_gemm
        bd.other += layers * t_attn
        if with_ar and self.tp > 1:
            # 2 ARs per layer on (m_tokens x d_model) bf16
            msg = m_tokens * cfg.d_model * 2
            tp_nodes = max(1, self.tp // self.g)
            t_ar = ar_time(msg, algo=self.ar_algo, n_nodes=tp_nodes,
                           g=min(self.tp, self.g), net=self.net)
            t_ar += self.straggler_delay
            bd.comm += layers * 2 * t_ar
        return bd

    # -- public: one full-model forward ------------------------------------
    def prefill_time(self, batch: int, prompt_len: int) -> StepBreakdown:
        cfg = self.cfg
        m = batch * prompt_len
        if self.pp == 1:
            return self._step_time(m, prompt_len, phase="prefill",
                                   layers=cfg.n_layers, with_ar=True)
        # GPipe: m microbatches through pp stages
        mb = max(1, self.microbatches)
        stage = self._step_time(m // mb, prompt_len, phase="prefill",
                                layers=cfg.n_layers // self.pp,
                                with_ar=True)
        factor = (mb + self.pp - 1) / mb
        out = StepBreakdown(matmul=stage.matmul * mb,
                            other=stage.other * mb,
                            comm=stage.comm * mb)
        # bubble shows up as idle
        out.idle = stage.total * mb * (factor - 1.0)
        # p2p activation sends between stages
        act = (m // mb) * cfg.d_model * 2
        out.comm += (self.pp - 1) * (self.net.alpha_inter
                                     + act / self.net.beta_inter) * mb
        return out

    def decode_step_time(self, batch: int, ctx: int) -> StepBreakdown:
        cfg = self.cfg
        if self.pp == 1:
            return self._step_time(batch, ctx, phase="decode",
                                   layers=cfg.n_layers, with_ar=True)
        # PP decode: the token must traverse all stages serially; splitting
        # the batch into microbatches cannot shrink the tile-floored GEMMs.
        mb = min(self.microbatches, max(1, batch))
        stage = self._step_time(max(1, batch // mb), ctx, phase="decode",
                                layers=cfg.n_layers // self.pp,
                                with_ar=True)
        steps = mb + self.pp - 1
        out = StepBreakdown(matmul=stage.matmul * mb,
                            other=stage.other * mb,
                            comm=stage.comm * mb)
        out.idle = stage.total * (steps - mb)
        act = max(1, batch // mb) * cfg.d_model * 2
        out.comm += (self.pp - 1) * (self.net.alpha_inter
                                     + act / self.net.beta_inter) * mb
        return out


def simulate_batch_latency(cfg: ModelConfig, chip: ChipSpec,
                           net: cm.NetworkSpec, n_gpus: int, *,
                           scheme: str, ar_algo: str,
                           prompt_len: int, decode_len: int,
                           n_prompts: int,
                           straggler_delay: float = 0.0
                           ) -> Tuple[float, StepBreakdown]:
    """Time-to-completion of one batch (the paper's batched-inference
    metric)."""
    sim = ClusterSim(cfg, chip, net, n_gpus, scheme=scheme,
                     ar_algo=ar_algo, straggler_delay=straggler_delay)
    total = StepBreakdown()
    total.add(sim.prefill_time(n_prompts, prompt_len))
    for t in range(decode_len):
        total.add(sim.decode_step_time(n_prompts, prompt_len + t))
    return total.total, total


def simulate_trace(cfg: ModelConfig, chip: ChipSpec, net: cm.NetworkSpec,
                   n_gpus: int, *, scheme: str, ar_algo: str,
                   arrivals: np.ndarray, in_lens: np.ndarray,
                   out_lens: np.ndarray, concurrency: int) -> Dict[str, float]:
    """Continuous-batching trace replay at step granularity (Figs. 9/18).

    Mixed prefill+decode steps: arrivals are admitted into free slots (up
    to ``concurrency``); each engine step advances every active request by
    one token, plus prefill cost for newly admitted ones.
    """
    sim = ClusterSim(cfg, chip, net, n_gpus, scheme=scheme, ar_algo=ar_algo)
    n = len(arrivals)
    order = np.argsort(arrivals)
    arrivals, in_lens, out_lens = (arrivals[order], in_lens[order],
                                   out_lens[order])
    now = 0.0
    qi = 0
    active: List[List[float]] = []   # [remaining, ctx]
    while qi < n or active:
        # admit
        while qi < n and arrivals[qi] <= now and len(active) < concurrency:
            now += sim.prefill_time(1, int(in_lens[qi])).total
            active.append([float(out_lens[qi]), float(in_lens[qi])])
            qi += 1
        if not active:
            now = max(now, arrivals[qi] if qi < n else now)
            if qi < n and arrivals[qi] > now:
                now = arrivals[qi]
            continue
        b = len(active)
        ctx = int(np.mean([a[1] for a in active]))
        now += sim.decode_step_time(b, ctx).total
        for a in active:
            a[0] -= 1
            a[1] += 1
        active = [a for a in active if a[0] > 0]
    total_out = float(np.sum(out_lens))
    return {"makespan_s": now, "output_tokens": total_out,
            "throughput_tok_s": total_out / now if now > 0 else 0.0}


__all__ = ["ChipSpec", "A100", "GH200", "V5E", "H100", "CHIP_FOR_NET",
           "ClusterSim", "StepBreakdown", "simulate_batch_latency",
           "simulate_trace", "ar_time"]
