"""Alpha-beta communication cost models of the paper (Eqs. 1 and 3-5): the
port's own copy of the parts of ``repro/core/comm_model.py`` that the
autotuner (:mod:`repro_torch.core.autotune`) calls.

The paper models all-reduce time on a system of ``N`` nodes x ``G`` GPUs a
node with intra-node latency/bandwidth (alpha_intra, beta_intra) and
inter-node (alpha_inter, beta_inter).  The network constants are the
paper's two systems (Perlmutter: A100 + Slingshot-11; Vista: GH200 +
InfiniBand) and the reference's TPU v5e target, kept so that a table saved
by either package names a network the other knows.

All times are in seconds; message sizes in bytes; bandwidths in
bytes/second.  The quantized-wire terms (``quant_wire_factor``,
``t_quant_hier_allreduce``) score the ``ar_quant`` levels.  Not copied
(nothing in the port calls them yet): the tree model, Eq. 4's
halving-free form, the NVRAR totals and speedup tables, and the
sequence-parallel terms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """alpha-beta parameters of a two-level interconnect."""

    name: str
    alpha_intra: float  # s, latency of the fast (intra-node) level
    beta_intra: float   # B/s, bandwidth of the fast level (per link)
    alpha_inter: float  # s, latency of the slow (inter-node) level
    beta_inter: float   # B/s, bandwidth of the slow level (per endpoint)
    gpus_per_node: int = 4


# Perlmutter: 4x A100 per node, NVLink3 (~2.4e11 B/s usable a direction),
# Slingshot-11 (~25 GB/s a NIC a direction); latencies from the NCCL/OSU
# small-message plateaus in the paper's Fig. 4.
PERLMUTTER = NetworkSpec(
    name="perlmutter",
    alpha_intra=8.0e-6,
    beta_intra=2.4e11,
    alpha_inter=16.0e-6,
    beta_inter=2.5e10,
    gpus_per_node=4,
)

# Vista: GH200, 1 GPU a node, InfiniBand NDR (~25 GB/s usable a direction).
VISTA = NetworkSpec(
    name="vista",
    alpha_intra=5.0e-6,
    beta_intra=4.5e11,   # irrelevant: G=1
    alpha_inter=12.0e-6,
    beta_inter=2.5e10,
    gpus_per_node=1,
)

# The reference's TPU v5e target ("node" = pod, "inter" = DCN between
# pods); kept only so that its tables load here.
TPU_V5E = NetworkSpec(
    name="tpu_v5e",
    alpha_intra=1.0e-6,
    beta_intra=5.0e10,
    alpha_inter=10.0e-6,
    beta_inter=6.25e9,
    gpus_per_node=256,
)

NETWORKS: Dict[str, NetworkSpec] = {
    n.name: n for n in (PERLMUTTER, VISTA, TPU_V5E)
}


def t_ring_allreduce(msg_bytes: float, n_nodes: int, gpus_per_node: int,
                     net: NetworkSpec) -> float:
    """Eq. (1): NCCL Ring all-reduce (flat ring, inter-node links dominate).

    T = 2(NG-1) a_inter + 2 (NG-1)/(NG) * |M| / b_inter
    """
    ng = n_nodes * gpus_per_node
    if ng <= 1:
        return 0.0
    return 2.0 * (ng - 1) * net.alpha_inter + \
        2.0 * (ng - 1) / ng * (msg_bytes / net.beta_inter)


def t_reduce_scatter_intra(msg_bytes: float, gpus_per_node: int,
                           net: NetworkSpec) -> float:
    """Eq. (3): intra-node ring reduce-scatter."""
    g = gpus_per_node
    if g <= 1:
        return 0.0
    return (g - 1) * net.alpha_intra \
        + (g - 1) / g * (msg_bytes / net.beta_intra)


def t_allgather_intra(msg_bytes: float, gpus_per_node: int,
                      net: NetworkSpec) -> float:
    """Eq. (5): intra-node ring all-gather (same cost shape as Eq. 3)."""
    return t_reduce_scatter_intra(msg_bytes, gpus_per_node, net)


def t_rd_inter_full_exchange(msg_bytes: float, n_nodes: int,
                             gpus_per_node: int, net: NetworkSpec,
                             eta: float = 1.0) -> float:
    """Recursive doubling as Algorithm 1 runs it: the full |M|/G payload
    at every one of the log2(N) steps, so the bandwidth term is
    log2(N) * |M|/G rather than Eq. (4)'s (N-1)/N * |M|/G."""
    if n_nodes <= 1:
        return 0.0
    steps = math.log2(n_nodes)
    return steps * net.alpha_inter + \
        steps * (eta * msg_bytes / (gpus_per_node * net.beta_inter))


def t_rd_halving_inter(msg_bytes: float, n_nodes: int, gpus_per_node: int,
                       net: NetworkSpec, eta: float = 1.0) -> float:
    """Recursive halving RS + recursive doubling AG over the slow level:
    total payload 2 (N-1)/N * |M|/G with 2 log2(N) latency steps."""
    if n_nodes <= 1:
        return 0.0
    return 2.0 * math.log2(n_nodes) * net.alpha_inter + \
        2.0 * (n_nodes - 1) / n_nodes \
        * (eta * msg_bytes / (gpus_per_node * net.beta_inter))


# ---------------------------------------------------------------------------
# Quantized (low-bit wire) collective terms
# ---------------------------------------------------------------------------

# Per-group scale granularity of the quantized collectives (the group caps
# of kernels/quant_pack, kept literal so the model stays dependency-free).
QUANT_GROUPS = {8: 128, 4: 64}

# Per-phase pack/unpack cost, charged once per quantized phase so that
# latency-bound small messages are not scored as free wins.
QUANT_PACK_OVERHEAD = 2.0e-6


def quant_wire_factor(bits: int, group: int = 0,
                      dtype_bytes: float = 2.0) -> float:
    """Wire bytes per full-precision byte for a quantized payload:
    ``bits``-wide values plus one bf16 scale per ``group`` elements
    (int8/g128 -> 0.508 of bf16, int4/g64 -> 0.266); ``group=0`` takes
    the level's default."""
    if group <= 0:
        group = QUANT_GROUPS[bits]
    return (bits / 8.0 + 2.0 / group) / dtype_bytes


def t_quant_hier_allreduce(msg_bytes: float, n_nodes: int,
                           gpus_per_node: int, net: NetworkSpec,
                           bits: int) -> float:
    """Quantized hierarchical all-reduce: RS (packed all-to-all) +
    quantized RD inter + AG (packed), every phase's bandwidth term scaled
    by the wire factor, plus the pack overhead per phase; the latency
    terms are unchanged (quantization buys bandwidth, not latency)."""
    g, n = max(1, gpus_per_node), max(1, n_nodes)
    wm = msg_bytes * quant_wire_factor(bits)
    phases = 2
    t = (t_reduce_scatter_intra(wm, g, net)
         + t_allgather_intra(wm, g, net))
    if n > 1:
        t += t_rd_inter_full_exchange(wm, n, g, net)
        # the symmetric RD requantizes the running sum every step
        phases += int(math.log2(n))
    return t + phases * QUANT_PACK_OVERHEAD


__all__ = [
    "NetworkSpec", "PERLMUTTER", "VISTA", "TPU_V5E", "NETWORKS",
    "t_ring_allreduce", "t_reduce_scatter_intra", "t_allgather_intra",
    "t_rd_inter_full_exchange", "t_rd_halving_inter", "QUANT_GROUPS",
    "QUANT_PACK_OVERHEAD", "quant_wire_factor", "t_quant_hier_allreduce",
]
