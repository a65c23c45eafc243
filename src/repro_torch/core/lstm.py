"""Traditional LSTM (Hochreiter & Schmidhuber, 1997): the paper's
sequential baseline (``repro.core.lstm``).

    f_t = sigma(Linear([x_t, h_{t-1}]))     i_t = sigma(Linear([x_t, h_{t-1}]))
    o_t = sigma(Linear([x_t, h_{t-1}]))     c~_t = tanh(Linear([x_t, h_{t-1}]))
    c_t = f_t * c_{t-1} + i_t * c~_t        h_t = o_t * tanh(c_t)

Sequential only: ``forward`` is a Python loop over T, trained by BPTT
through autograd.  Fused 4-gate weight layout, O(4 dh (dx + dh))
parameters as in the paper.  It runs no kernel of the repo.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import nn


def init(gen: torch.Generator, d_in: int, d_hidden: int, *,
         dtype=torch.float32, use_bias: bool = True):
    return {
        "wx": nn.dense_init(gen, d_in, 4 * d_hidden, use_bias=use_bias,
                            dtype=dtype),
        "wh": nn.dense_init(gen, d_hidden, 4 * d_hidden, use_bias=False,
                            dtype=dtype),
    }


def n_params(d_in: int, d_hidden: int, use_bias: bool = False) -> int:
    return 4 * d_hidden * (d_in + d_hidden) + (4 * d_hidden if use_bias else 0)


def step(params, x_t: torch.Tensor,
         state: Tuple[torch.Tensor, torch.Tensor],
         compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    h_prev, c_prev = state
    gx = nn.dense_apply(params["wx"], x_t, compute_dtype)
    gh = h_prev @ params["wh"]["kernel"].to(h_prev.dtype)
    fx, ix, ox, cx = gx.chunk(4, dim=-1)
    fh, ih, oh, ch = gh.chunk(4, dim=-1)
    f = torch.sigmoid(fx + fh)
    i = torch.sigmoid(ix + ih)
    o = torch.sigmoid(ox + oh)
    c = f * c_prev + i * torch.tanh(cx + ch)
    return o * torch.tanh(c), c


def forward(params, x: torch.Tensor, state0=None,
            compute_dtype=None) -> torch.Tensor:
    """x: (..., T, d_in) -> h: (..., T, d_hidden), one step at a time."""
    dh = params["wh"]["kernel"].shape[0]
    if state0 is None:
        z = x.new_zeros(x.shape[:-2] + (dh,))
        state0 = (z, z)
    state = state0
    hs = []
    for t in range(x.shape[-2]):
        state = step(params, x[..., t, :], state, compute_dtype)
        hs.append(state[0])
    return torch.stack(hs, dim=-2)
