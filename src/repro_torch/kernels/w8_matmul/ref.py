"""Plain PyTorch version of the W8 GEMM (``csrc/w8_matmul.cu``): the
weight dequantized as the reference's ``dequant_layer`` builds it, then
the rank-batched product (what a CPU tensor runs, and the oracle the
kernel is held against on the card)."""
from __future__ import annotations

import torch


def dequant_weight(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q (R, K, N) int8 and s (R, P) bf16, N a multiple of P, column n
    scaled by s[n % P] -> (R, K, N) bf16: ``bf16(float(q) * float(s))``."""
    R, K, N = q.shape
    sn = s.float().repeat(1, N // s.shape[1])
    return (q.float() * sn[:, None, :]).to(torch.bfloat16)


def w8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """x (R, M, K) @ dequant(q, s) -> (R, M, N) in x's type."""
    return torch.bmm(x, dequant_weight(q, s).to(x.dtype))


__all__ = ["dequant_weight", "w8_matmul_ref"]
