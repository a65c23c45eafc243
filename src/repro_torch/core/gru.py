"""Traditional GRU (Cho et al., 2014): the paper's sequential baseline
(``repro.core.gru``).

    z_t = sigma(Linear([x_t, h_{t-1}]))
    r_t = sigma(Linear([x_t, h_{t-1}]))
    h~_t = tanh(Linear([x_t, r_t * h_{t-1}]))
    h_t = (1 - z_t) * h_{t-1} + z_t * h~_t

Sequential only: ``forward`` is a Python loop over T, trained by BPTT
through autograd (Fig. 1's runtime comparison and the parameter-count
ratios).  Fused 3-gate weight layout, as the reference's.  It runs no
kernel of the repo: PyTorch ops on the device of its inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nn


def init(gen: torch.Generator, d_in: int, d_hidden: int, *,
         dtype=torch.float32, use_bias: bool = True):
    return {
        "wx": nn.dense_init(gen, d_in, 3 * d_hidden, use_bias=use_bias,
                            dtype=dtype),
        "wh": nn.dense_init(gen, d_hidden, 3 * d_hidden, use_bias=False,
                            dtype=dtype),
    }


def n_params(d_in: int, d_hidden: int, use_bias: bool = False) -> int:
    return 3 * d_hidden * (d_in + d_hidden) + (3 * d_hidden if use_bias else 0)


def step(params, x_t: torch.Tensor, h_prev: torch.Tensor,
         compute_dtype=None) -> torch.Tensor:
    gx = nn.dense_apply(params["wx"], x_t, compute_dtype)
    gh = h_prev @ params["wh"]["kernel"].to(h_prev.dtype)
    zx, rx, hx = gx.chunk(3, dim=-1)
    zh, rh, hh = gh.chunk(3, dim=-1)
    z = torch.sigmoid(zx + zh)
    r = torch.sigmoid(rx + rh)
    h_tilde = torch.tanh(hx + r * hh)
    return (1.0 - z) * h_prev + z * h_tilde


def forward(params, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
            compute_dtype=None) -> torch.Tensor:
    """x: (..., T, d_in) -> (..., T, d_hidden), one step at a time."""
    dh = params["wh"]["kernel"].shape[0]
    h = x.new_zeros(x.shape[:-2] + (dh,)) if h0 is None else h0
    hs = []
    for t in range(x.shape[-2]):
        h = step(params, x[..., t, :], h, compute_dtype)
        hs.append(h)
    return torch.stack(hs, dim=-2)
