"""Plain PyTorch version of the RWKV6 time-mix scan kernel: the port of
``repro/models/rwkv.py::rwkv_scan_ref`` (the step-exact recurrence, a loop
over T in f32), with the kernel's grouped bonus operand: ``u`` holds G
groups, sequence n reading group n // (N // G)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (N, T, H, hd); u: (G, H, hd), G dividing N; s0: (N, H,
    hd, hd) or None (zeros).  Per step t, per (n, h):

        y_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(exp(logw_t)) S
        + k_t v_t^T

    Returns y (N, T, H, hd) and the final S (N, H, hd, hd), f32."""
    N, T = r.shape[:2]
    uf = u.float().repeat_interleave(N // u.shape[0], dim=0)[..., None]
    s = torch.zeros((N, *r.shape[2:], r.shape[-1]), dtype=torch.float32,
                    device=r.device) if s0 is None else s0.float()
    ys = []
    for t in range(T):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("nhk,nhkv->nhv", rt, s + uf * kv))
        s = torch.exp(logw[:, t].float())[..., None] * s + kv
    return torch.stack(ys, dim=1), s


__all__ = ["rwkv6_scan_ref"]
