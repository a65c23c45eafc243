"""MLP variants (``repro.models.mlp``): plain, and gated (GeGLU for
gemma, SwiGLU for the llama family)."""

from __future__ import annotations

import torch

from repro_torch.core import nn


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             bias: bool = False, dtype=torch.float32):
    p = {"up": nn.dense_init(gen, d_model, d_ff, use_bias=bias, dtype=dtype),
         "down": nn.dense_init(gen, d_ff, d_model, use_bias=bias,
                               dtype=dtype)}
    if gated:
        p["gate"] = nn.dense_init(gen, d_model, d_ff, use_bias=bias,
                                  dtype=dtype)
    return p


def mlp_flops(d_model: int, d_ff: int, gated: bool) -> int:
    """Matmul FLOPs per token (forward)."""
    n_mats = 3 if gated else 2
    return 2 * n_mats * d_model * d_ff


def mlp_apply(params, x: torch.Tensor, *, activation: str = "silu",
              compute_dtype=None) -> torch.Tensor:
    act = nn.ACTIVATIONS[activation]
    up = nn.dense_apply(params["up"], x, compute_dtype)
    if "gate" in params:
        h = act(nn.dense_apply(params["gate"], x, compute_dtype)) * up
    else:
        h = act(up)
    return nn.dense_apply(params["down"], h, compute_dtype)
