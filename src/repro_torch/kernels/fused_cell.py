"""What the fused minGRU and minLSTM wrappers share: the launch of a
``csrc/fused_cell.cuh`` kernel and the layer's custom backward.

Backward (mirrors ``repro.kernels.fused_mingru.ops._bwd``): the fp32
gates (a, b) are recomputed from the saved inputs with plain torch ops,
the reversed CUDA linear scan gives g_t = dh_t + a_{t+1} g_{t+1}
(``scan.ops.reverse_scan_grads``), and ``torch.autograd.grad`` pulls
(dL/da, dL/db) = (g h_{t-1}, g) back through the gates to x, the weights
and the biases.  Those transposed products lie outside the TPU kernel in
the reference too.  The saved h is the kernel's rounded output, cast to
fp32 exactly as the reference casts it.

Two kernel bodies (``csrc/fused_cell.cuh``): the tensor-core body for
bf16 operands whose rows and bases allow 16-byte asynchronous copies, the
CUDA-core body for fp32 and for any other bf16.  The C launcher picks the
body before the launch and reports the one it took; the wrappers count
each body's launches beside the total.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.launch import waves
from repro_torch.kernels.scan import ops as scan_ops


# the kernel's bodies, by the C launcher's number (1: tensor cores)
BODIES = ("cuda_core", "tc")


def declare(lib, fn_name: str):
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    occ = getattr(lib, fn_name.replace("_launch", "_occupancy"))
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    kl.declare_error_string(lib)


def _operands(name, x, ws, bs, h0, mode):
    """Check the operands; returns (code, shape, h0 fp32, out, pointers)."""
    if mode not in ("log", "linear"):
        raise ValueError(f"unknown mode {mode!r}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, Dx), got "
                         f"{tuple(x.shape)}")
    code = kl.element_type(x, f"{name} x")
    bsz, t, dx = x.shape
    dh = ws[0].shape[-1]
    dev, dt = x.device, x.dtype
    h0 = h0.float()
    kl.check(x, "x", (bsz, t, dx), dt)
    for i, (w, b) in enumerate(zip(ws, bs)):
        kl.check(w, f"weight {i}", (dx, dh), dt, dev)
        kl.check(b, f"bias {i}", (dh,), dt, dev)
    kl.check(h0, "h0", (bsz, dh), torch.float32, dev)
    out = torch.empty((bsz, t, dh), dtype=dt, device=dev)
    if kl.shape_only(x):            # a dry run's operands have no address
        return code, (bsz, t, dx, dh), h0, out, None
    ptrs = [x.data_ptr()] + [w.data_ptr() for w in ws] \
        + [b.data_ptr() for b in bs] + [h0.data_ptr(), out.data_ptr()]
    return code, (bsz, t, dx, dh), h0, out, ptrs


def work(n_gates: int, dtype: torch.dtype, bsz: int, t: int, dx: int,
         dh: int):
    """(flops, bytes) of one fused layer of ``n_gates`` projections: the
    projections' multiply-adds; x, the weights and biases (``dtype``) and
    the fp32 h0 read once, h (``dtype``) written once."""
    e = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * bsz * t * dx * dh * n_gates
    nbytes = e * (bsz * t * dx + n_gates * (dx * dh + dh) + bsz * t * dh) \
        + 4 * bsz * dh
    return flops, nbytes


def launch(get_lib, fn_name: str, name: str, x, ws, bs, h0, *, mode: str,
           normalize: bool = False):
    """Check the operands and launch one fused layer on x's stream.
    x: (B, T, Dx); ws: G (Dx, Dh); bs: G (Dh,), all of x's dtype;
    h0: (B, Dh), taken as fp32 -> (h (B, T, Dh) in x's dtype, the body
    that ran, as the launcher reports it).  ``get_lib()`` builds and loads
    the library, after the checks.  Fake CUDA operands take the
    shape-only route: the body is None, nothing is launched."""
    code, shape, h0, out, ptrs = _operands(name, x, ws, bs, h0, mode)
    if ptrs is None:
        kl.record(name, 1, work(len(ws), x.dtype, *shape))
        return out, None
    lib = get_lib()
    fn = getattr(lib, fn_name)
    body = ctypes.c_int(-1)
    rc = fn(code, int(mode == "log"), int(normalize), *shape,
            (ctypes.c_void_p * len(ptrs))(*ptrs), kl.stream(x.device),
            ctypes.byref(body))
    kl.raise_on_error(lib, name, rc)
    return out, BODIES[body.value]


def occupancy(get_lib, fn_name: str, name: str, x, ws, bs, h0, *,
              mode: str, normalize: bool = False) -> dict:
    """What a launch on these operands would run, from the C launcher's
    own choice and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``:
    {"body", "blocks_per_sm", "grid_blocks", "sms", "waves"}.  Launches
    nothing."""
    code, shape, h0, out, ptrs = _operands(name, x, ws, bs, h0, mode)
    lib = get_lib()
    occ = getattr(lib, fn_name.replace("_launch", "_occupancy"))
    res = (ctypes.c_int * 4)()
    with torch.cuda.device(x.device):
        rc = occ(code, int(mode == "log"), int(normalize), *shape,
                 (ctypes.c_void_p * len(ptrs))(*ptrs), res)
    kl.raise_on_error(lib, f"{name} occupancy", rc)
    b, per_sm, blocks, sms = list(res)
    return {"body": BODIES[b], "blocks_per_sm": per_sm,
            "grid_blocks": blocks, "sms": sms,
            "waves": waves(blocks, per_sm, sms)}


class FusedCell(torch.autograd.Function):
    """h = kernel(x, h0, *wb); backward through ``gates(x, *wb)``, the
    fp32 (a, b) scan inputs.  ``wb`` are the weights and biases in the
    cell's order; missing biases come in as zeros."""

    @staticmethod
    def forward(ctx, kernel, gates, x, h0, *wb):
        h = kernel(x, h0, *wb)
        ctx.gates = gates
        ctx.save_for_backward(x, h0, h, *wb)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h0, h, *wb = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, *wb)]
            a, b = ctx.gates(*leaves)
        acc = a.dtype                      # fp32 (fp64 for fp64 inputs)
        g, h_prev, dh0 = scan_ops.reverse_scan_grads(
            a.detach(), dh.to(acc), h.to(acc), h0.to(acc))
        grads = torch.autograd.grad((a, b), leaves, (g * h_prev, g))
        grads = [gr.to(t.dtype) for gr, t in zip(grads, (x, *wb))]
        return (None, None, grads[0], dh0.to(h0.dtype), *grads[1:])


def with_defaults(x, ws, bs, h0):
    """Missing biases -> zeros (Dh,), missing h0 -> zeros (B, Dh), in x's
    dtype, as the reference wrapper makes them."""
    dh = ws[0].shape[-1]
    bs = [torch.zeros((dh,), dtype=x.dtype, device=x.device) if b is None
          else b for b in bs]
    if h0 is None:
        h0 = torch.zeros((x.shape[0], dh), dtype=x.dtype, device=x.device)
    return bs, h0
