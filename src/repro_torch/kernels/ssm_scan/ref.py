"""Plain PyTorch version of the Mamba selective-scan kernel: the port of
``repro/kernels/ssm_scan/ref.py::ssm_scan_ref`` as a loop over T of the
exact step in f32 (the reference evaluates the same recurrence with an
associative scan), with the kernel's grouped ``A`` operand: ``a`` holds G
groups, sequence n reading group n // (N // G)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (N, T, Ci); b/c: (N, T, S); a: (G, Ci, S), G dividing N; h0:
    (N, Ci, S) or None (zeros).  Per step t:

        h <- exp(a dt_t) h + (dt_t x_t) b_t^T;  y_t = h c_t

    Returns y (N, T, Ci) and the final h (N, Ci, S), f32."""
    N, T, Ci = x.shape
    af = a.float().repeat_interleave(N // a.shape[0], dim=0)
    h = torch.zeros((N, Ci, b.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.float()
    ys = []
    for t in range(T):
        dtt = dt[:, t].float()
        drive = (dtt * x[:, t].float())[..., None] * b[:, t, None].float()
        h = torch.exp(af * dtt[..., None]) * h + drive
        ys.append((h * c[:, t, None].float()).sum(-1))
    return torch.stack(ys, dim=1), h


__all__ = ["ssm_scan_ref"]
