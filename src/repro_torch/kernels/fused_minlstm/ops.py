"""Wrapper for the fused minLSTM kernel (``csrc/fused_minlstm.cu``), with
its backward.

Mirrors ``kernels/fused_mingru/ops.py``: the forward is one launch (three
projections, the stable normalised gates, g(), the scan; only h leaves
the kernel); the backward recomputes the fp32 gates, runs the reversed
CUDA linear scan g_t = dh_t + f'_{t+1} g_{t+1}, and pulls (g h_{t-1}, g)
back through the gates (the f/(f+i) normalisation jacobian included).

``fused_minlstm_kernel`` is the raw wrapper: a CPU tensor goes to the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises;
a fake CUDA tensor takes the shape-only route (``kernels/launch.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import fused_cell
from repro_torch.kernels.fused_minlstm import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_minlstm.cu"
_FN = "repro_fused_minlstm_launch"

# launches of the kernel, and of each body ("fused_minlstm_kernel/tc",
# "fused_minlstm_kernel/cuda_core"): plain counts, reset by whoever reads them
LAUNCHES = {"fused_minlstm_kernel": 0,
            **{f"fused_minlstm_kernel/{b}": 0 for b in fused_cell.BODIES}}
_LIB = None


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        fused_cell.declare(lib, _FN)
        _LIB = lib
    return _LIB


def fused_minlstm_kernel(x, wf, bf, wi, bi, wh, bh, h0, *,
                         mode: str = "log", normalize: bool = True):
    """x: (B, T, Dx) -> h: (B, T, Dh) in x's dtype; weights and biases
    in x's dtype, h0 (B, Dh) taken as fp32."""
    if x.device.type == "cpu":
        return ref.fused_minlstm_ref(x, wf, bf, wi, bi, wh, bh, h0,
                                     mode=mode, normalize=normalize)
    return launch(x, wf, bf, wi, bi, wh, bh, h0, mode=mode,
                  normalize=normalize)


def launch(x, wf, bf, wi, bi, wh, bh, h0, *, mode: str = "log",
           normalize: bool = True) -> torch.Tensor:
    """Launch the kernel on x's stream (CUDA tensors only)."""
    out, body = fused_cell.launch(_lib, _FN, "fused_minlstm_kernel", x,
                                  (wf, wi, wh), (bf, bi, bh), h0, mode=mode,
                                  normalize=normalize)
    if body is not None:       # None: a dry run's shape-only call
        LAUNCHES["fused_minlstm_kernel"] += 1
        LAUNCHES[f"fused_minlstm_kernel/{body}"] += 1
    return out


def work(dtype: torch.dtype, bsz: int, t: int, dx: int, dh: int):
    """(flops, bytes) of one launch on (B, T, Dx) x of ``dtype`` to Dh
    (``fused_cell.work`` of its 3 projections)."""
    return fused_cell.work(3, dtype, bsz, t, dx, dh)


def occupancy(x, wf, bf, wi, bi, wh, bh, h0, *, mode: str = "log",
              normalize: bool = True) -> dict:
    """The body, resident blocks per SM, grid and waves a launch on these
    CUDA operands would run (``fused_cell.occupancy``); launches
    nothing."""
    return fused_cell.occupancy(_lib, _FN, "fused_minlstm_kernel", x,
                                (wf, wi, wh), (bf, bi, bh), h0, mode=mode,
                                normalize=normalize)


def fused_minlstm(x: torch.Tensor, wf: torch.Tensor,
                  bf: Optional[torch.Tensor], wi: torch.Tensor,
                  bi: Optional[torch.Tensor], wh: torch.Tensor,
                  bh: Optional[torch.Tensor],
                  h0: Optional[torch.Tensor] = None, *, mode: str = "log",
                  normalize: bool = True) -> torch.Tensor:
    """minLSTM layer (projections + recurrence) in one launch,
    differentiable in x, the three weight / bias pairs and h0."""
    (bf, bi, bh), h0 = fused_cell.with_defaults(x, (wf, wi, wh),
                                                (bf, bi, bh), h0)

    def kernel(x_, h0_, wf_, bf_, wi_, bi_, wh_, bh_):
        return fused_minlstm_kernel(x_, wf_, bf_, wi_, bi_, wh_, bh_, h0_,
                                    mode=mode, normalize=normalize)

    def gates(x_, wf_, bf_, wi_, bi_, wh_, bh_):
        return ref.gates_fp32(x_, wf_, bf_, wi_, bi_, wh_, bh_, mode,
                              normalize)

    return fused_cell.FusedCell.apply(kernel, gates, x, h0, wf, bf, wi, bi,
                                      wh, bh)
