"""Rotary position embeddings (``repro.models.rope``): the angles in
fp32, the rotated result cast back to the input's dtype.  ``apply_rope``
is ``rotate`` by ``rope_tables``; a decode step builds the tables once
for all its layers."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, (head_dim // 2,) fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(cos, sin) of the angles at ``positions`` (..., T): (..., T,
    head_dim // 2) fp32 each."""
    freqs = rope_freqs(head_dim, theta, positions.device)      # (d/2,)
    angles = positions[..., None].float() * freqs              # (..., T, d/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D) rotated by ``rope_tables``'
    (..., T, D/2) tables, in fp32, back in x's dtype."""
    if x.ndim == cos.ndim + 1:                                 # (..., T, H, D)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); positions: (..., T) integers."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
