"""Plain PyTorch versions of the cell-only decode kernels
(``csrc/decode_step.cu``).

Same arithmetic as ``repro.kernels.decode_step.ref``: inputs cast to fp32,
the projections, gates and state update in fp32, the output cast to x's
dtype.  These are NOT ``min_gru.step`` / ``min_lstm.step``: those compute
the projections and gates in the compute dtype, which gives other bf16
numbers.

The chunk versions re-emit each row's carried state at every position
past ``valid`` (frozen rows repeat their final state), so position
``valid[b] - 1`` onward holds the row's final state.
"""

from __future__ import annotations

import torch

from repro_torch.core import nn
from repro_torch.core.min_lstm import normalized_gates


def mingru_step_ref(x, wz, bz, wh, bh, h_prev, *, mode: str = "log"):
    """x: (B, Dx), h_prev: (B, Dh) -> h_t: (B, Dh)."""
    x32 = x.float()
    k = x32 @ wz.float() + bz.float()
    v = x32 @ wh.float() + bh.float()
    z = torch.sigmoid(k)
    h_tilde = nn.g(v) if mode == "log" else v
    h = (1.0 - z) * h_prev.float() + z * h_tilde
    return h.to(x.dtype)


def minlstm_step_ref(x, wf, bf, wi, bi, wh, bh, h_prev, *,
                     mode: str = "log", normalize: bool = True):
    """x: (B, Dx), h_prev: (B, Dh) -> h_t: (B, Dh)."""
    x32 = x.float()
    kf = x32 @ wf.float() + bf.float()
    ki = x32 @ wi.float() + bi.float()
    v = x32 @ wh.float() + bh.float()
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    h_tilde = nn.g(v) if mode == "log" else v
    h = f * h_prev.float() + i * h_tilde
    return h.to(x.dtype)


def _chunk_scan(step_one, x, h_prev, valid):
    """Apply ``step_one`` per token; row b freezes once ``t >= valid[b]``
    and re-emits its frozen h."""
    hs = []
    h = h_prev
    for t in range(x.shape[1]):
        h_new = step_one(x[:, t], h)
        h = torch.where((t < valid)[:, None], h_new, h).to(h.dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def mingru_chunk_ref(x, wz, bz, wh, bh, h_prev, valid, *, mode: str = "log"):
    """x: (B, C, Dx), h_prev: (B, Dh), valid: (B,) int in [1, C] -> hs:
    (B, C, Dh): ``valid[b]`` masked sequential ``mingru_step_ref``
    updates, rows frozen beyond their valid length."""
    return _chunk_scan(
        lambda x_t, h: mingru_step_ref(x_t, wz, bz, wh, bh, h, mode=mode),
        x, h_prev, valid)


def minlstm_chunk_ref(x, wf, bf, wi, bi, wh, bh, h_prev, valid, *,
                      mode: str = "log", normalize: bool = True):
    """The minLSTM chunk; shapes as :func:`mingru_chunk_ref`."""
    return _chunk_scan(
        lambda x_t, h: minlstm_step_ref(x_t, wf, bf, wi, bi, wh, bh, h,
                                        mode=mode, normalize=normalize),
        x, h_prev, valid)
