"""Plain PyTorch version of the fused minLSTM kernel
(``csrc/fused_minlstm.cu``).

It follows ``repro.kernels.fused_minlstm.ref.fused_minlstm_ref`` in the
kernel's arithmetic: inputs cast to fp32 (float64 stays float64), fp32
sums and gates (the stable ``normalized_gates``, not the naive
f/(f+i)), an fp32 carry from h0, the output rounded to x's dtype.
Differentiable by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nn
from repro_torch.core.min_lstm import normalized_gates
from repro_torch.kernels.scan.ref import linear_scan_ref, wide


def gates_fp32(x, wf, bf, wi, bi, wh, bh, mode: str = "log",
               normalize: bool = True):
    """The (a, b) scan inputs in fp32: (f', i' * h~)."""
    acc = wide(x.dtype)
    x32 = x.to(acc)
    kf = x32 @ wf.to(acc) + bf.to(acc)
    ki = x32 @ wi.to(acc) + bi.to(acc)
    v = x32 @ wh.to(acc) + bh.to(acc)
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    h_tilde = nn.g(v) if mode == "log" else v
    return f, i * h_tilde


def fused_minlstm_ref(x: torch.Tensor, wf: torch.Tensor, bf: torch.Tensor,
                      wi: torch.Tensor, bi: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor, h0: Optional[torch.Tensor] = None,
                      mode: str = "log",
                      normalize: bool = True) -> torch.Tensor:
    """x: (B, T, Dx); w*: (Dx, Dh); b*: (Dh,); h0: (B, Dh)."""
    a, b = gates_fp32(x, wf, bf, wi, bi, wh, bh, mode, normalize)
    if h0 is None:
        h0 = torch.zeros(x.shape[:-2] + (wf.shape[1],), device=x.device)
    return linear_scan_ref(a, b, h0).to(x.dtype)
