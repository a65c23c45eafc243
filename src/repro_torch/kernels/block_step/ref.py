"""Plain PyTorch versions of the whole-block decode kernel.

The same op sequence as ``repro.kernels.block_step.ref``: pre-norm
RMSNorm (fp32 inside), causal-conv step, fp32 cell update (minGRU /
minLSTM with the stable f/(f+i)), compute-dtype down / MLP products.
``ops.py`` runs these for CPU tensors, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.  Params are one block's dict
(``blocks.init`` layout).
"""

from __future__ import annotations

import torch

from repro_torch.core import min_lstm, nn


def _cell_step(cell: str, mode: str, rnn, y, h_prev, compute_dtype):
    """fp32 cell update: compute-dtype input upcast to fp32, weights
    upcast to fp32, output cast back to the input dtype."""
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    out_dtype = y.dtype
    y32 = y.float()

    def proj(name):
        p = y32 @ rnn[name]["kernel"].float()
        if "bias" in rnn[name]:
            p = p + rnn[name]["bias"].float()
        return p

    h32 = h_prev.float()
    if cell == "mingru":
        z = torch.sigmoid(proj("wz"))
        v = proj("wh")
        h_tilde = nn.g(v) if mode == "log" else v
        h = (1.0 - z) * h32 + z * h_tilde
    else:
        f, i = min_lstm.normalized_gates(proj("wf"), proj("wi"))
        v = proj("wh")
        h_tilde = nn.g(v) if mode == "log" else v
        h = f * h32 + i * h_tilde
    return h.to(out_dtype)


def _residual(params, x_t, h, use_mlp, compute_dtype):
    x_t = x_t + nn.dense_apply(params["down"], h, compute_dtype)
    if use_mlp:
        y = nn.rmsnorm_apply(params["norm_mlp"], x_t)
        y = nn.gelu(nn.dense_apply(params["mlp_in"], y, compute_dtype))
        x_t = x_t + nn.dense_apply(params["mlp_out"], y, compute_dtype)
    return x_t


def block_step_ref(params, x_t, state, *, cell: str = "mingru",
                   mode: str = "log", use_conv: bool = True,
                   use_mlp: bool = True, compute_dtype=None):
    """One residual block decode step.  x_t: (B, d_model), state:
    {"h": (B, d_hidden)[, "conv": (B, K-1, d_model)]} -> (y, new_state)."""
    y = nn.rmsnorm_apply(params["norm_rnn"], x_t)
    new_state = dict(state)
    if use_conv:
        y, new_state["conv"] = nn.causal_conv_step(params["conv"], y,
                                                   state["conv"])
    h = _cell_step(cell, mode, params["rnn"], y, state["h"], compute_dtype)
    new_state["h"] = h
    return _residual(params, x_t, h, use_mlp, compute_dtype), new_state


def block_chunk_ref(params, x, state, valid, *, cell: str = "mingru",
                    mode: str = "log", use_conv: bool = True,
                    use_mlp: bool = True, compute_dtype=None):
    """Varlen chunk: ``valid[b]`` masked sequential block steps.
    x: (B, C, d_model), valid: (B,) in [1, C] -> (ys (B, C, d_model),
    new_state, per-position states {"h": (B, C, d_hidden)[, "conv":
    (B, C, K-1, d_model)]}).  Frozen rows re-emit their final state, and
    the residual / down / MLP at a frozen position read the frozen h."""
    st = dict(state)
    ys, pos = [], {k: [] for k in state}
    for t in range(x.shape[1]):
        keep = t < valid
        x_t = x[:, t]
        y = nn.rmsnorm_apply(params["norm_rnn"], x_t)
        st_new = dict(st)
        if use_conv:
            y, win_new = nn.causal_conv_step(params["conv"], y, st["conv"])
            st_new["conv"] = torch.where(keep[:, None, None], win_new,
                                         st["conv"])
        h_new = _cell_step(cell, mode, params["rnn"], y, st["h"],
                           compute_dtype)
        st_new["h"] = torch.where(keep[:, None], h_new,
                                  st["h"]).to(st["h"].dtype)
        ys.append(_residual(params, x_t, st_new["h"], use_mlp,
                            compute_dtype))
        st = st_new
        for k in pos:
            pos[k].append(st[k])
    ys = torch.stack(ys, dim=1)
    pos = {k: torch.stack(v, dim=1) for k, v in pos.items()}
    return ys, st, pos
