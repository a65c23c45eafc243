"""Wrapper for the fused minGRU kernel (``csrc/fused_mingru.cu``), with
its backward.

Forward: one launch runs both gate projections, the gates and the scan,
writing only h -- the k, v (B, T, Dh) activations never reach device
memory.  Backward (``kernels/fused_cell.FusedCell``): the fp32 gates are
recomputed with plain torch ops, the reversed CUDA linear scan gives
g_t = dh_t + (1 - z_{t+1}) g_{t+1}, and autograd pulls (g h_{t-1}, g)
back through the gates.

``fused_mingru_kernel`` is the raw wrapper: a CPU tensor goes to the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises;
a fake CUDA tensor takes the shape-only route (``kernels/launch.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import fused_cell
from repro_torch.kernels.fused_mingru import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_mingru.cu"
_FN = "repro_fused_mingru_launch"

# launches of the kernel, and of each body ("fused_mingru_kernel/tc",
# "fused_mingru_kernel/cuda_core"): plain counts, reset by whoever reads them
LAUNCHES = {"fused_mingru_kernel": 0,
            **{f"fused_mingru_kernel/{b}": 0 for b in fused_cell.BODIES}}
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


def fused_mingru_kernel(x, wz, bz, wh, bh, h0, *, mode: str = "log"):
    """x: (B, T, Dx) -> h: (B, T, Dh) in x's dtype; weights and biases
    in x's dtype, h0 (B, Dh) taken as fp32."""
    if x.device.type == "cpu":
        return ref.fused_mingru_ref(x, wz, bz, wh, bh, h0, mode=mode)
    return launch(x, wz, bz, wh, bh, h0, mode=mode)


def launch(x, wz, bz, wh, bh, h0, *, mode: str = "log") -> torch.Tensor:
    """Launch the kernel on x's stream (CUDA tensors only)."""
    out, body = fused_cell.launch(_lib, _FN, "fused_mingru_kernel", x,
                                  (wz, wh), (bz, bh), h0, mode=mode)
    if body is not None:       # None: a dry run's shape-only call
        LAUNCHES["fused_mingru_kernel"] += 1
        LAUNCHES[f"fused_mingru_kernel/{body}"] += 1
    return out


def work(dtype: torch.dtype, bsz: int, t: int, dx: int, dh: int):
    """(flops, bytes) of one launch on (B, T, Dx) x of ``dtype`` to Dh
    (``fused_cell.work`` of its 2 projections)."""
    return fused_cell.work(2, dtype, bsz, t, dx, dh)


def occupancy(x, wz, bz, wh, bh, h0, *, mode: str = "log") -> dict:
    """The body, resident blocks per SM, grid and waves a launch on these
    CUDA operands would run (``fused_cell.occupancy``); launches
    nothing."""
    return fused_cell.occupancy(_lib, _FN, "fused_mingru_kernel", x,
                                (wz, wh), (bz, bh), h0, mode=mode)


def fused_mingru(x: torch.Tensor, wz: torch.Tensor,
                 bz: Optional[torch.Tensor], wh: torch.Tensor,
                 bh: Optional[torch.Tensor],
                 h0: Optional[torch.Tensor] = None, *,
                 mode: str = "log") -> torch.Tensor:
    """minGRU layer (projections + recurrence) in one launch, differentiable
    in x, the weights and biases, and h0."""
    (bz, bh), h0 = fused_cell.with_defaults(x, (wz, wh), (bz, bh), h0)

    def kernel(x_, h0_, wz_, bz_, wh_, bh_):
        return fused_mingru_kernel(x_, wz_, bz_, wh_, bh_, h0_, mode=mode)

    def gates(x_, wz_, bz_, wh_, bh_):
        return ref.gates_fp32(x_, wz_, bz_, wh_, bh_, mode)

    return fused_cell.FusedCell.apply(kernel, gates, x, h0, wz, bz, wh, bh)
