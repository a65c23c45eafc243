"""minLSTM (the paper's Section 3.2): init and the sequential decode forms.

    f_t, i_t = sigma(Linear_dh(x_t)), sigma(Linear_dh(x_t))
    h~_t = Linear_dh(x_t)           (linear mode) | g(Linear_dh(x_t)) (log)
    f'_t, i'_t = f/(f+i), i/(f+i)   (computed stably, see normalized_gates)
    h_t  = f'_t * h_{t-1} + i'_t * h~_t
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import nn
from repro_torch.core.min_gru import _no_cell_kernel


def init(gen: torch.Generator, d_in: int, d_hidden: int, *,
         dtype=torch.float32, use_bias: bool = True,
         forget_bias: float = 0.0):
    return {
        "wf": nn.dense_init(gen, d_in, d_hidden, use_bias=use_bias,
                            dtype=dtype, bias_init=forget_bias),
        "wi": nn.dense_init(gen, d_in, d_hidden, use_bias=use_bias,
                            dtype=dtype),
        "wh": nn.dense_init(gen, d_in, d_hidden, use_bias=use_bias,
                            dtype=dtype),
    }


def normalized_gates(kf: torch.Tensor, ki: torch.Tensor):
    """f' = f/(f+i), i' = i/(f+i) in the stable form sigmoid(-diff),
    sigmoid(diff) with diff = softplus(-kf) - softplus(-ki): the naive
    quotient is 0/0 once both sigmoids underflow."""
    diff = F.softplus(-kf) - F.softplus(-ki)
    return torch.sigmoid(-diff), torch.sigmoid(diff)


def step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
         mode: str = "log", normalize: bool = True, compute_dtype=None,
         scan_strategy: Optional[str] = None) -> torch.Tensor:
    _no_cell_kernel(scan_strategy)
    kf = nn.dense_apply(params["wf"], x_t, compute_dtype)
    ki = nn.dense_apply(params["wi"], x_t, compute_dtype)
    v = nn.dense_apply(params["wh"], x_t, compute_dtype)
    h_tilde = nn.g(v) if mode == "log" else v
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    return f * h_prev + i * h_tilde


def step_chunk(params, x: torch.Tensor, h_prev: torch.Tensor,
               valid: torch.Tensor, *, mode: str = "log",
               normalize: bool = True, compute_dtype=None,
               scan_strategy: Optional[str] = None) -> torch.Tensor:
    _no_cell_kernel(scan_strategy)
    hs = []
    h = h_prev
    for t in range(x.shape[-2]):
        h_new = step(params, x[..., t, :], h, mode=mode,
                     normalize=normalize, compute_dtype=compute_dtype)
        h = torch.where((t < valid)[..., None], h_new, h).to(h.dtype)
        hs.append(h)
    return torch.stack(hs, dim=-2)
