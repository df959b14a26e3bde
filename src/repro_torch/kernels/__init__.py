"""Hand-written Hopper (sm_90a) kernels of the port.

Each kernel subpackage ships:
  ops.py — the wrapper: checks operands, allocates the output, launches the
           CUDA kernel on the current stream for CUDA tensors (counting
           launches in ``<wrapper>.launches``) or runs the plain version
           for CPU tensors
  ref.py — the plain PyTorch version, the CPU path and the oracle the
           kernel is held against on the card

The CUDA sources live in ``csrc/`` and are built by ``_build`` with nvcc on
first use.  Unlike the JAX package, whose layers never call their Pallas
kernels, the port's layers call these wrappers on the executed path.
"""
from .decode_attention import decode_attention, paged_decode_attention
from .flash_attention import flash_attention
from .fused_matmul_rd import collective_matmul_rd
from .moe_gemm import moe_expert_ffn
from .quant_pack import quantize_pack, unpack_dequant
from .quant_rd_allreduce import quant_rd_all_reduce
from .rd_allreduce import rd_all_reduce
from .rwkv6_scan import rwkv6_scan
from .ssm_scan import ssm_scan


def kernel_wrappers():
    """Every kernel wrapper, for launch accounting."""
    return (flash_attention, decode_attention, paged_decode_attention,
            rd_all_reduce, collective_matmul_rd, quantize_pack,
            unpack_dequant, quant_rd_all_reduce, moe_expert_ffn, rwkv6_scan,
            ssm_scan)


__all__ = ["flash_attention", "decode_attention", "paged_decode_attention",
           "rd_all_reduce", "collective_matmul_rd", "quantize_pack",
           "unpack_dequant", "quant_rd_all_reduce", "moe_expert_ffn",
           "rwkv6_scan", "ssm_scan", "kernel_wrappers"]
