"""minGRU (the paper's Section 3.1): init and the sequential decode forms.

    z_t  = sigma(Linear_dh(x_t))
    h~_t = Linear_dh(x_t)            (linear mode) | g(Linear_dh(x_t)) (log)
    h_t  = (1 - z_t) * h_{t-1} + z_t * h~_t

The parallel (training / prefill) forms come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nn
from repro_torch.core import scan as scan_lib


def init(gen: torch.Generator, d_in: int, d_hidden: int, *,
         dtype=torch.float32, use_bias: bool = True):
    return {
        "wz": nn.dense_init(gen, d_in, d_hidden, use_bias=use_bias,
                            dtype=dtype),
        "wh": nn.dense_init(gen, d_in, d_hidden, use_bias=use_bias,
                            dtype=dtype),
    }


def _no_cell_kernel(scan_strategy):
    if scan_strategy is not None and \
            scan_lib.resolve_strategy(scan_strategy) == "fused":
        raise NotImplementedError(
            "the cell-only decode kernels (kernels/decode_step) are not "
            "ported yet (ROADMAP.md queue 1, item 3); the block-fused "
            "tier or scan_strategy='sequential' serves instead")


def step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
         mode: str = "log", compute_dtype=None,
         scan_strategy: Optional[str] = None) -> torch.Tensor:
    """x_t: (..., d_in), h_prev: (..., d_hidden) -> h_t (plain PyTorch;
    the oracle the kernels are held against)."""
    _no_cell_kernel(scan_strategy)
    z = torch.sigmoid(nn.dense_apply(params["wz"], x_t, compute_dtype))
    v = nn.dense_apply(params["wh"], x_t, compute_dtype)
    h_tilde = nn.g(v) if mode == "log" else v
    return (1.0 - z) * h_prev + z * h_tilde


def step_chunk(params, x: torch.Tensor, h_prev: torch.Tensor,
               valid: torch.Tensor, *, mode: str = "log",
               compute_dtype=None,
               scan_strategy: Optional[str] = None) -> torch.Tensor:
    """Packed varlen decode chunk: x (B, C, d_in), valid (B,) in [1, C]
    -> hs (B, C, d_hidden); row b freezes once t >= valid[b]."""
    _no_cell_kernel(scan_strategy)
    hs = []
    h = h_prev
    for t in range(x.shape[-2]):
        h_new = step(params, x[..., t, :], h, mode=mode,
                     compute_dtype=compute_dtype)
        h = torch.where((t < valid)[..., None], h_new, h).to(h.dtype)
        hs.append(h)
    return torch.stack(hs, dim=-2)
