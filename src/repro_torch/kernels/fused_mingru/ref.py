"""Plain PyTorch version of the fused minGRU kernel
(``csrc/fused_mingru.cu``).

It follows ``repro.kernels.fused_mingru.ref.fused_mingru_ref`` --
projections, gates, a sequential scan -- in the kernel's arithmetic: the
inputs cast to fp32 (float64 stays float64), fp32 sums and gates, an
fp32 carry from h0, the output rounded to x's dtype.  In fp32 that is
the reference oracle exactly.  It is differentiable by autograd, so it
is also the plain version of the layer's gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nn
from repro_torch.kernels.scan.ref import linear_scan_ref, wide


def gates_fp32(x, wz, bz, wh, bh, mode: str = "log"):
    """The (a, b) scan inputs in fp32: (1 - z, z * h~)."""
    acc = wide(x.dtype)
    x32 = x.to(acc)
    k = x32 @ wz.to(acc) + bz.to(acc)
    v = x32 @ wh.to(acc) + bh.to(acc)
    z = torch.sigmoid(k)
    h_tilde = nn.g(v) if mode == "log" else v
    return 1.0 - z, z * h_tilde


def fused_mingru_ref(x: torch.Tensor, wz: torch.Tensor, bz: torch.Tensor,
                     wh: torch.Tensor, bh: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     mode: str = "log") -> torch.Tensor:
    """x: (B, T, Dx); wz, wh: (Dx, Dh); bz, bh: (Dh,); h0: (B, Dh)."""
    a, b = gates_fp32(x, wz, bz, wh, bh, mode)
    if h0 is None:
        h0 = torch.zeros(x.shape[:-2] + (wz.shape[1],), device=x.device)
    return linear_scan_ref(a, b, h0).to(x.dtype)
