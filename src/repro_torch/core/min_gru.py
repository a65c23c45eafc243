"""minGRU (the paper's Section 3.1).

    z_t  = sigma(Linear_dh(x_t))
    h~_t = Linear_dh(x_t)            (linear mode) | g(Linear_dh(x_t)) (log)
    h_t  = (1 - z_t) * h_{t-1} + z_t * h~_t

``parallel`` is the training form (the fused CUDA layer under "auto");
``step`` / ``step_chunk`` are the sequential decode forms (the cell-only
CUDA decode kernels under "auto").
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


def n_params(d_in: int, d_hidden: int, use_bias: bool = False) -> int:
    """The elements of ``init``'s leaves: two gate projections (the
    paper's claim (1), fewer parameters than a GRU's three)."""
    return 2 * d_in * d_hidden + (2 * d_hidden if use_bias else 0)


# ---------------------------------------------------------------------------
# Parallel (training) forms
# ---------------------------------------------------------------------------

def parallel(params, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
             mode: str = "log", scan_strategy: str = "associative",
             compute_dtype=None) -> torch.Tensor:
    """x: (..., T, d_in) -> h: (..., T, d_hidden).

    ``"auto"`` / ``"fused"`` run the whole layer (projections + scan) in
    the fused CUDA kernel; ``"pallas"`` keeps torch projections and scans
    in the CUDA scan kernels (the log-space one for ``mode="log"``); the
    other strategies are plain torch.  In log mode only ``"pallas"``
    changes the scan: the rest run the associative Heinsen scan."""
    if mode not in ("log", "linear"):
        raise ValueError(f"unknown minGRU mode {mode!r}")
    strategy = scan_lib.resolve_strategy(scan_strategy)
    if strategy == "fused":
        return _fused_parallel(params, x, h0, mode=mode,
                               compute_dtype=compute_dtype)
    k = nn.dense_apply(params["wz"], x, compute_dtype)   # gate pre-act
    v = nn.dense_apply(params["wh"], x, compute_dtype)   # candidate
    if mode == "log":
        # Appendix B Algorithm 6, scanned in fp32 for stability
        log_z = nn.log_sigmoid(k.float())
        log_coeffs = nn.log_sigmoid(-k.float())          # log(1 - z)
        log_h_tilde = nn.log_g(v.float())
        log_h0 = None if h0 is None else torch.log(h0.float())
        h = scan_lib.scan_log_space(log_coeffs, log_z + log_h_tilde, log_h0,
                                    strategy=strategy)
        return h.to(x.dtype if compute_dtype is None else compute_dtype)
    z = torch.sigmoid(k)
    return scan_lib.scan_linear(1.0 - z, z * v, h0, strategy=strategy)


def _fused_parallel(params, x, h0, *, mode: str, compute_dtype=None):
    """Whole layer in one CUDA launch (kernels/fused_mingru)."""
    from repro_torch.kernels.fused_mingru import ops as fused_ops
    from repro_torch.kernels.scan.ops import call_with_flat_lead
    wz, wh = params["wz"]["kernel"], params["wh"]["kernel"]
    bz, bh = params["wz"].get("bias"), params["wh"].get("bias")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        wz, wh = wz.to(compute_dtype), wh.to(compute_dtype)
        bz = None if bz is None else bz.to(compute_dtype)
        bh = None if bh is None else bh.to(compute_dtype)
    if h0 is None:                          # the kernel wants (B, T, D)
        return call_with_flat_lead(
            lambda xf: fused_ops.fused_mingru(xf, wz, bz, wh, bh,
                                              mode=mode), (x, 2))
    return call_with_flat_lead(
        lambda xf, h0f: fused_ops.fused_mingru(xf, wz, bz, wh, bh, h0f,
                                               mode=mode), (x, 2), (h0, 1))


def gates(params, x: torch.Tensor, *, mode: str = "log",
          compute_dtype=None):
    """The linear-space (a, b) recurrence inputs, (1 - z, z * h~), for
    external scans -- in log mode too, where scanning them linearly is
    the log-space scan up to rounding."""
    k = nn.dense_apply(params["wz"], x, compute_dtype)
    v = nn.dense_apply(params["wh"], x, compute_dtype)
    z = torch.sigmoid(k)
    h_tilde = nn.g(v) if mode == "log" else v
    return 1.0 - z, z * h_tilde


# ---------------------------------------------------------------------------
# Sequential (decode) forms
# ---------------------------------------------------------------------------

def step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
         mode: str = "log", compute_dtype=None,
         scan_strategy: Optional[str] = None, operands=None) -> torch.Tensor:
    """x_t: (..., d_in), h_prev: (..., d_hidden) -> h_t.

    ``"auto"`` / ``"fused"`` run the whole step (both projections, the
    gates, the update) in the cell-only CUDA decode kernel
    (``kernels/decode_step``); ``None`` or any other strategy runs the
    plain PyTorch step below.  ``operands``: these weights bound for the
    kernel (``kernels.decode_step.ops.CellOperands``), if the caller holds
    them."""
    if scan_strategy is not None and \
            scan_lib.resolve_strategy(scan_strategy) == "fused":
        return _fused_step(params, x_t, h_prev, mode=mode,
                           compute_dtype=compute_dtype, operands=operands)
    z = torch.sigmoid(nn.dense_apply(params["wz"], x_t, compute_dtype))
    v = nn.dense_apply(params["wh"], x_t, compute_dtype)
    h_tilde = nn.g(v) if mode == "log" else v
    return (1.0 - z) * h_prev + z * h_tilde


def _fused_step_args(params, x: torch.Tensor, compute_dtype, operands=None):
    """The kernel's operands: x and every weight / bias cast to the
    compute dtype (the bound ones when ``operands`` is given)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if operands is not None:
        wz, bz, wh, bh = operands.args
        return x, wz, bz, wh, bh
    wz, wh = params["wz"]["kernel"], params["wh"]["kernel"]
    bz, bh = params["wz"].get("bias"), params["wh"].get("bias")
    if compute_dtype is not None:
        wz, wh = wz.to(compute_dtype), wh.to(compute_dtype)
        bz = None if bz is None else bz.to(compute_dtype)
        bh = None if bh is None else bh.to(compute_dtype)
    return x, wz, bz, wh, bh


def _fused_step(params, x_t: torch.Tensor, h_prev: torch.Tensor, *,
                mode: str, compute_dtype=None, operands=None):
    """Whole cell step in one CUDA launch (kernels/decode_step)."""
    from repro_torch.kernels.decode_step import ops as step_ops
    x_t, wz, bz, wh, bh = _fused_step_args(params, x_t, compute_dtype,
                                           operands)
    return step_ops.fused_mingru_step(x_t, wz, bz, wh, bh, h_prev, mode=mode,
                                      operands=operands)


def step_chunk(params, x: torch.Tensor, h_prev: torch.Tensor,
               valid: torch.Tensor, *, mode: str = "log",
               compute_dtype=None, scan_strategy: Optional[str] = None,
               operands=None) -> torch.Tensor:
    """Packed varlen decode chunk: x (..., C, d_in), h_prev (...,
    d_hidden), valid (...,) in [1, C] -> hs (..., C, d_hidden).  Row b
    advances through its first ``valid[b]`` tokens with the per-token
    arithmetic of :func:`step` and freezes after.  ``"auto"`` /
    ``"fused"`` run the chunk in one CUDA launch that reads the weights
    once; anything else is the plain masked sequential loop."""
    if scan_strategy is not None and \
            scan_lib.resolve_strategy(scan_strategy) == "fused":
        from repro_torch.kernels.decode_step import ops as step_ops
        x, wz, bz, wh, bh = _fused_step_args(params, x, compute_dtype,
                                             operands)
        return step_ops.fused_mingru_chunk(x, wz, bz, wh, bh, h_prev, valid,
                                           mode=mode, operands=operands)
    hs = []
    h = h_prev
    for t in range(x.shape[-2]):
        h_new = step(params, x[..., t, :], h, mode=mode,
                     compute_dtype=compute_dtype)
        h = torch.where((t < valid)[..., None], h_new, h).to(h.dtype)
        hs.append(h)
    return torch.stack(hs, dim=-2)
