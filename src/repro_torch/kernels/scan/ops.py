"""Wrappers for the scan kernels (``csrc/scan.cu``), with their backward.

Two differentiable entry points share one backward structure, as in
``repro.kernels.scan.ops``:

  * ``linear_scan``    -- h_t = a_t h_{t-1} + b_t (the ``"pallas"`` /
    ``mode="linear"`` path);
  * ``log_space_scan`` -- the same recurrence given (log a, log b), with a
    log-space carry; output fp32 (the ``"pallas"`` / ``mode="log"`` path).

The backward of h_t = a_t h_{t-1} + b_t is itself a reversed linear scan,

    g_t = dL/dh_t + a_{t+1} g_{t+1},   dL/db_t = g_t,
    dL/da_t = g_t h_{t-1},             dL/dh0 = a_1 g_1,

which ``reverse_scan_grads`` runs through the CUDA linear scan with its
``reverse`` flag (no flipped copies).  It is the backward of every fused
cell layer too.

``linear_scan_kernel`` / ``log_scan_kernel`` are the raw wrappers: a CPU
tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises; a fake CUDA tensor takes the shape-only route
(``kernels/launch.py``).  Nothing falls back.

The kernels run a segmented two-level scan (``csrc/scan.cu``): one block
of ``WARPS`` warps per (batch row, ``COLS`` columns); each warp scans its
own ``SEG``-step segment of a T-tile, folds the earlier segments'
aggregates onto the tile's carry in order, and fixes its prefixes up.
``plan`` gives that launch's shape for a (B, T, D) without a card,
``occupancy`` adds the card's resident blocks per SM and waves;
``ref.linear_scan_segmented`` / ``ref.log_scan_segmented`` render
its order in PyTorch ops.  The order depends on T alone, so two launches
agree bit for bit and a row does not depend on B.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan.cu"
# csrc/scan.cu's kSeg, kWarps, kCols
SEG, WARPS, COLS = ref.SEG, ref.WARPS, 32

# launches per kernel: a plain count, reset by whoever reads it
LAUNCHES = {"linear_scan_kernel": 0, "log_scan_kernel": 0}
_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        ptr = ctypes.c_void_p
        lib.repro_linear_scan.argtypes = [ctypes.c_int] * 5 + [ptr] * 5
        lib.repro_linear_scan.restype = ctypes.c_int
        lib.repro_log_scan.argtypes = [ctypes.c_int] * 4 + [ptr] * 5
        lib.repro_log_scan.restype = ctypes.c_int
        lib.repro_scan_plan.argtypes = [ctypes.c_int] * 5 + [ptr]
        lib.repro_scan_plan.restype = ctypes.c_int
        kl.declare_error_string(lib)
        _LIB = lib
    return _LIB


def plan(bsz: int, t: int, d: int) -> dict:
    """The launch either scan kernel runs on (B, T, D) inputs: ``seg``
    steps a warp owns, ``warps`` segments (warps) a block, ``cols``
    columns a block, the ``tiles`` of seg x warps steps a block walks, and
    the ``grid`` (column tiles, B) of ``blocks``."""
    grid = (-(-d // COLS), bsz)
    return {"seg": SEG, "warps": WARPS, "threads": 32 * WARPS,
            "cols": COLS, "tiles": -(-t // (SEG * WARPS)), "grid": grid,
            "blocks": grid[0] * grid[1]}


def occupancy(kind: str, dtype: torch.dtype, bsz: int, t: int, d: int,
              device=None) -> dict:
    """``plan`` with the card's ``blocks_per_sm`` (the occupancy query for
    the kernel of ``kind`` "linear" or "log" and ``dtype``), ``sms`` and
    ``waves``; raises if the C launcher's constants differ from
    ``plan``'s.  Launches nothing."""
    out = plan(bsz, t, d)
    lib = _lib()
    res = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        rc = lib.repro_scan_plan(int(kind == "log"), kl.DTYPES[dtype],
                                 bsz, t, d, res)
    kl.raise_on_error(lib, "scan plan", rc)
    seg, warps, cols, tiles, blocks, per_sm, sms = list(res)
    c_plan = {"seg": seg, "warps": warps, "cols": cols, "tiles": tiles,
              "blocks": blocks}
    if any(out[k] != v for k, v in c_plan.items()):
        raise RuntimeError(f"scan plan: the C launcher runs {c_plan}, "
                           f"ops.plan says {out}")
    out.update(blocks_per_sm=per_sm, sms=sms,
               waves=kl.waves(blocks, per_sm, sms))
    return out


def work(kind: str, dtype: torch.dtype, bsz: int, t: int, d: int):
    """(flops, bytes) of one scan of ``kind`` "linear" or "log" over
    (B, T, D) inputs of ``dtype``: both inputs and the fp32 h0 read once,
    the output (``dtype``; fp32 for "log") written once.  Its FLOPs are
    0: elementwise work, which ``FlopCounterMode`` does not count."""
    e = torch.tensor([], dtype=dtype).element_size()
    out_e = 4 if kind == "log" else e
    return 0, bsz * t * d * (2 * e + out_e) + 4 * bsz * d


def _check_scan(name, x, y, h0):
    if x.dim() != 3:
        raise ValueError(f"{name}: inputs must be (B, T, D), got "
                         f"{tuple(x.shape)}")
    bsz, t, d = x.shape
    code = kl.element_type(x, f"{name} input")
    kl.check(x, f"{name} input 0", (bsz, t, d), x.dtype)
    kl.check(y, f"{name} input 1", (bsz, t, d), x.dtype, x.device)
    kl.check(h0, f"{name} initial state", (bsz, d), torch.float32, x.device)
    return code, bsz, t, d


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                       reverse: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over (B, T, D), fp32 carry from ``h0``
    (B, D), output in ``b.dtype``; ``reverse`` walks t = T-1 .. 0."""
    if a.device.type == "cpu":
        return ref.linear_scan_ref(a, b, h0, reverse=reverse)
    return launch_linear_scan(a, b, h0, reverse)


def launch_linear_scan(a, b, h0, reverse: bool = False) -> torch.Tensor:
    """Launch the linear-scan kernel on a's stream (CUDA tensors only)."""
    h0 = h0.float()
    code, bsz, t, d = _check_scan("linear_scan_kernel", a, b, h0)
    out = torch.empty_like(b)
    if kl.shape_only(a):
        kl.record("linear_scan_kernel", 1, work("linear", a.dtype, bsz, t, d))
        return out
    lib = _lib()
    rc = lib.repro_linear_scan(code, int(reverse), bsz, t, d, a.data_ptr(),
                               b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                               kl.stream(a.device))
    kl.raise_on_error(lib, "linear_scan_kernel", rc)
    LAUNCHES["linear_scan_kernel"] += 1
    return out


def log_scan_kernel(log_a: torch.Tensor, log_b: torch.Tensor,
                    log_h0: torch.Tensor) -> torch.Tensor:
    """exp of log_h_t = logaddexp(log_a_t + log_h_{t-1}, log_b_t) over
    (B, T, D) from ``log_h0`` (B, D; -inf = zero state); output fp32."""
    if log_a.device.type == "cpu":
        return ref.log_scan_ref(log_a, log_b, log_h0)
    return launch_log_scan(log_a, log_b, log_h0)


def launch_log_scan(log_a, log_b, log_h0) -> torch.Tensor:
    """Launch the log-space scan kernel (CUDA tensors only)."""
    log_h0 = log_h0.float()
    code, bsz, t, d = _check_scan("log_scan_kernel", log_a, log_b, log_h0)
    out = torch.empty((bsz, t, d), dtype=torch.float32, device=log_a.device)
    if kl.shape_only(log_a):
        kl.record("log_scan_kernel", 1, work("log", log_a.dtype, bsz, t, d))
        return out
    lib = _lib()
    rc = lib.repro_log_scan(code, bsz, t, d, log_a.data_ptr(),
                            log_b.data_ptr(), log_h0.data_ptr(),
                            out.data_ptr(), kl.stream(log_a.device))
    kl.raise_on_error(lib, "log_scan_kernel", rc)
    LAUNCHES["log_scan_kernel"] += 1
    return out


def call_with_flat_lead(fn, *specs):
    """Collapse arbitrary leading dims to one batch dim around ``fn``.
    ``specs`` are (tensor, n_trailing) pairs; the leading dims come from
    the first pair and must agree across all of them."""
    x0, t0 = specs[0]
    lead = x0.shape[:-t0] if t0 else x0.shape
    if len(lead) == 1:
        return fn(*(x for x, _ in specs))
    n = math.prod(lead)
    flat = [x.reshape((n,) + x.shape[len(lead):]) for x, _ in specs]
    out = fn(*flat)
    return out.reshape(tuple(lead) + out.shape[1:])


def reverse_scan_grads(a, dh, h, h0):
    """Shared backward core for h_t = a_t h_{t-1} + b_t.

    Runs g_t = dh_t + a_{t+1} g_{t+1} through the linear-scan kernel
    reversed and returns ``(g, h_prev, dh0)`` with ``dh0 = a_1 g_1``.
    All arrays are linear-space and share one dtype chosen by the caller;
    the coefficients live in (0, 1) and g is finite and signed, so linear
    space is safe even when the forward ran in log space."""
    a_next = torch.cat([a[..., 1:, :], torch.zeros_like(a[..., :1, :])],
                       dim=-2)
    g = linear_scan_kernel(a_next, dh.contiguous(), torch.zeros_like(h0),
                           reverse=True)
    h_prev = torch.cat([h0[..., None, :], h[..., :-1, :]], dim=-2)
    dh0 = a[..., 0, :] * g[..., 0, :]
    return g, h_prev, dh0


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = linear_scan_kernel(a.contiguous(), b.contiguous(), h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        g, h_prev, dh0 = reverse_scan_grads(a, dh.to(h.dtype), h,
                                            h0.to(h.dtype))
        return g * h_prev, g, dh0.to(h0.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """Differentiable h_t = a_t h_{t-1} + b_t.  a, b: (B, T, D);
    h0: (B, D)."""
    return _LinearScan.apply(a, b, h0)


def linear_scan_auto(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Default h0 = 0 (in b's dtype); flattens extra leading dims."""
    if h0 is None:
        h0 = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=b.dtype,
                         device=b.device)
    return call_with_flat_lead(linear_scan, (a, 2), (b, 2), (h0, 1))


class _LogSpaceScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, log_b, log_h0):
        h = log_scan_kernel(log_a.contiguous(), log_b.contiguous(), log_h0)
        ctx.save_for_backward(log_a, log_b, log_h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, log_b, log_h0, h = ctx.saved_tensors
        acc = h.dtype                      # fp32 (fp64 for fp64 inputs)
        a = torch.exp(log_a.to(acc))
        h0 = torch.exp(log_h0.to(acc))
        g, h_prev, dh0 = reverse_scan_grads(a, dh.to(acc), h, h0)
        # chain rule through the exp parameterisation: d/dlog_x = x d/dx
        dlog_a = (g * h_prev * a).to(log_a.dtype)
        dlog_b = (g * torch.exp(log_b.to(acc))).to(log_b.dtype)
        dlog_h0 = (dh0 * h0).to(log_h0.dtype)
        return dlog_a, dlog_b, dlog_h0


def log_space_scan(log_a: torch.Tensor, log_b: torch.Tensor,
                   log_h0: torch.Tensor) -> torch.Tensor:
    """Differentiable h_t = exp(log_a_t) h_{t-1} + exp(log_b_t); log_a,
    log_b: (B, T, D), log_h0: (B, D) with -inf encoding h0 = 0.  Output
    h is linear-space fp32."""
    return _LogSpaceScan.apply(log_a, log_b, log_h0)


def log_space_scan_auto(log_a: torch.Tensor, log_b: torch.Tensor,
                        log_h0: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Default log_h0 = -inf (h0 = 0); flattens extra leading dims."""
    if log_h0 is None:
        log_h0 = torch.full(log_a.shape[:-2] + log_a.shape[-1:],
                            float("-inf"), dtype=ref.wide(log_a.dtype),
                            device=log_a.device)
    return call_with_flat_lead(log_space_scan, (log_a, 2), (log_b, 2),
                               (log_h0, 1))
