"""Plain PyTorch versions of the scan kernels (``csrc/scan.cu``).

They follow ``repro.kernels.scan.ref.linear_scan_ref`` -- a sequential
walk over T -- with the kernels' arithmetic: an fp32 carry, the output
rounded to ``b``'s dtype (linear) or left in fp32 (log space).  The CPU
path of every wrapper in ``ops.py`` runs these; on a card they are what
``chip_smoke.py`` holds the kernels against.  "fp32" means at least fp32:
float64 inputs stay float64, so a float64 gradcheck can run through them.
"""

from __future__ import annotations

import torch


def wide(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype for ``dtype``: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim -2 (reversed: t = T-1 .. 0 with
    h_t = a_t * h_{t+1} + b_t).  a, b: (B, T, D); h0: (B, D)."""
    acc = wide(b.dtype)
    h = h0.to(acc)
    order = range(a.shape[-2] - 1, -1, -1) if reverse else \
        range(a.shape[-2])
    hs = [None] * a.shape[-2]
    for t in order:
        h = a[..., t, :].to(acc) * h + b[..., t, :].to(acc)
        hs[t] = h
    return torch.stack(hs, dim=-2).to(b.dtype)


def log_scan_ref(log_a: torch.Tensor, log_b: torch.Tensor,
                 log_h0: torch.Tensor) -> torch.Tensor:
    """log_h_t = logaddexp(log_a_t + log_h_{t-1}, log_b_t); returns
    exp(log_h) in fp32.  ``log_h0`` = -inf encodes h0 = 0, and
    ``torch.logaddexp(-inf, -inf)`` is -inf, as the kernel's."""
    acc = wide(log_b.dtype)
    lh = log_h0.to(acc)
    hs = []
    for t in range(log_a.shape[-2]):
        lh = torch.logaddexp(log_a[..., t, :].to(acc) + lh,
                             log_b[..., t, :].to(acc))
        hs.append(torch.exp(lh))
    return torch.stack(hs, dim=-2)
