"""minLSTM (the paper's Section 3.2).

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
from repro_torch.core import scan as scan_lib


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


def n_params(d_in: int, d_hidden: int, use_bias: bool = False) -> int:
    """The elements of ``init``'s leaves: three gate projections (an
    LSTM's are four, each also over h)."""
    return 3 * d_in * d_hidden + (3 * d_hidden if use_bias else 0)


def normalized_gates(kf: torch.Tensor, ki: torch.Tensor):
    """f' = f/(f+i), i' = i/(f+i) in the stable form sigmoid(-diff),
    sigmoid(diff) with diff = softplus(-kf) - softplus(-ki): the naive
    quotient is 0/0 once both sigmoids underflow."""
    diff = F.softplus(-kf) - F.softplus(-ki)
    return torch.sigmoid(-diff), torch.sigmoid(diff)


def _normalized_log_gates(kf: torch.Tensor, ki: torch.Tensor):
    """Appendix B Algorithm 8: log f', log i' from gate pre-activations."""
    diff = F.softplus(-kf) - F.softplus(-ki)
    return -F.softplus(diff), -F.softplus(-diff)


def parallel(params, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
             mode: str = "log", normalize: bool = True,
             scan_strategy: str = "associative",
             compute_dtype=None) -> torch.Tensor:
    """See ``min_gru.parallel`` for the strategy contract; ``"auto"`` /
    ``"fused"`` run the whole layer in the fused CUDA minLSTM kernel."""
    if mode not in ("log", "linear"):
        raise ValueError(f"unknown minLSTM mode {mode!r}")
    strategy = scan_lib.resolve_strategy(scan_strategy)
    if strategy == "fused":
        return _fused_parallel(params, x, h0, mode=mode, normalize=normalize,
                               compute_dtype=compute_dtype)
    kf = nn.dense_apply(params["wf"], x, compute_dtype)
    ki = nn.dense_apply(params["wi"], x, compute_dtype)
    v = nn.dense_apply(params["wh"], x, compute_dtype)
    if mode == "log":
        kf32, ki32 = kf.float(), ki.float()
        if normalize:
            log_f, log_i = _normalized_log_gates(kf32, ki32)
        else:
            log_f, log_i = nn.log_sigmoid(kf32), nn.log_sigmoid(ki32)
        log_h_tilde = nn.log_g(v.float())
        log_h0 = None if h0 is None else torch.log(h0.float())
        h = scan_lib.scan_log_space(log_f, log_i + log_h_tilde, log_h0,
                                    strategy=strategy)
        return h.to(x.dtype if compute_dtype is None else compute_dtype)
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    return scan_lib.scan_linear(f, i * v, h0, strategy=strategy)


def _fused_parallel(params, x, h0, *, mode: str, normalize: bool,
                    compute_dtype=None):
    """Whole layer in one CUDA launch (kernels/fused_minlstm)."""
    from repro_torch.kernels.fused_minlstm import ops as fused_ops
    from repro_torch.kernels.scan.ops import call_with_flat_lead
    ws = [params[k]["kernel"] for k in ("wf", "wi", "wh")]
    bs = [params[k].get("bias") for k in ("wf", "wi", "wh")]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        ws = [w.to(compute_dtype) for w in ws]
        bs = [None if b is None else b.to(compute_dtype) for b in bs]
    wf, wi, wh = ws
    bf, bi, bh = bs
    if h0 is None:                          # the kernel wants (B, T, D)
        return call_with_flat_lead(
            lambda xf: fused_ops.fused_minlstm(
                xf, wf, bf, wi, bi, wh, bh, mode=mode, normalize=normalize),
            (x, 2))
    return call_with_flat_lead(
        lambda xf, h0f: fused_ops.fused_minlstm(
            xf, wf, bf, wi, bi, wh, bh, h0f, mode=mode, normalize=normalize),
        (x, 2), (h0, 1))


def gates(params, x: torch.Tensor, *, mode: str = "log",
          normalize: bool = True, compute_dtype=None):
    """Linear-space (a, b) recurrence inputs, (f', i' * h~), for external
    scans (as ``min_gru.gates``)."""
    kf = nn.dense_apply(params["wf"], x, compute_dtype)
    ki = nn.dense_apply(params["wi"], x, compute_dtype)
    v = nn.dense_apply(params["wh"], x, compute_dtype)
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    h_tilde = nn.g(v) if mode == "log" else v
    return f, i * h_tilde


def step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
         mode: str = "log", normalize: bool = True, compute_dtype=None,
         scan_strategy: Optional[str] = None, operands=None) -> torch.Tensor:
    """x_t: (..., d_in), h_prev: (..., d_hidden) -> h_t.  ``"auto"`` /
    ``"fused"`` run the whole step in the cell-only CUDA decode kernel
    (``kernels/decode_step``); otherwise plain PyTorch.  Both normalise
    through the stable ``normalized_gates`` form."""
    if scan_strategy is not None and \
            scan_lib.resolve_strategy(scan_strategy) == "fused":
        return _fused_step(params, x_t, h_prev, mode=mode,
                           normalize=normalize, compute_dtype=compute_dtype,
                           operands=operands)
    kf = nn.dense_apply(params["wf"], x_t, compute_dtype)
    ki = nn.dense_apply(params["wi"], x_t, compute_dtype)
    v = nn.dense_apply(params["wh"], x_t, compute_dtype)
    h_tilde = nn.g(v) if mode == "log" else v
    if normalize:
        f, i = normalized_gates(kf, ki)
    else:
        f, i = torch.sigmoid(kf), torch.sigmoid(ki)
    return f * h_prev + i * h_tilde


def _fused_step_args(params, x: torch.Tensor, compute_dtype, operands=None):
    """x, wf, wi, wh, bf, bi, bh cast to the compute dtype (the bound
    weights when ``operands`` is given), as ``min_gru._fused_step_args``."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if operands is not None:
        wf, bf, wi, bi, wh, bh = operands.args
        return x, wf, wi, wh, bf, bi, bh
    ws = [params[k]["kernel"] for k in ("wf", "wi", "wh")]
    bs = [params[k].get("bias") for k in ("wf", "wi", "wh")]
    if compute_dtype is not None:
        ws = [w.to(compute_dtype) for w in ws]
        bs = [None if b is None else b.to(compute_dtype) for b in bs]
    return (x,) + tuple(ws) + tuple(bs)


def _fused_step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
                mode: str, normalize: bool, compute_dtype=None,
                operands=None):
    """Whole cell step in one CUDA launch (kernels/decode_step)."""
    from repro_torch.kernels.decode_step import ops as step_ops
    x_t, wf, wi, wh, bf, bi, bh = _fused_step_args(params, x_t,
                                                   compute_dtype, operands)
    return step_ops.fused_minlstm_step(x_t, wf, bf, wi, bi, wh, bh, h_prev,
                                       mode=mode, normalize=normalize,
                                       operands=operands)


def step_chunk(params, x: torch.Tensor, h_prev: torch.Tensor,
               valid: torch.Tensor, *, mode: str = "log",
               normalize: bool = True, compute_dtype=None,
               scan_strategy: Optional[str] = None,
               operands=None) -> torch.Tensor:
    """Packed varlen decode chunk; contract as ``min_gru.step_chunk``."""
    if scan_strategy is not None and \
            scan_lib.resolve_strategy(scan_strategy) == "fused":
        from repro_torch.kernels.decode_step import ops as step_ops
        x, wf, wi, wh, bf, bi, bh = _fused_step_args(params, x,
                                                     compute_dtype, operands)
        return step_ops.fused_minlstm_chunk(x, wf, bf, wi, bi, wh, bh,
                                            h_prev, valid, mode=mode,
                                            normalize=normalize,
                                            operands=operands)
    hs = []
    h = h_prev
    for t in range(x.shape[-2]):
        h_new = step(params, x[..., t, :], h, mode=mode,
                     normalize=normalize, compute_dtype=compute_dtype)
        h = torch.where((t < valid)[..., None], h_new, h).to(h.dtype)
        hs.append(h)
    return torch.stack(hs, dim=-2)
