"""What every ctypes kernel wrapper of the port shares: the operand checks
made before a pointer is handed to C, the current stream, turning a
returned CUDA status into an exception, and the waves a grid needs.  Nothing here touches a GPU at
import time.

It also holds the wrappers' shape-only route (``launch/dryrun.py``): a
``FakeTensor`` on the ``cuda`` device is checked as a launch's operand
is, its outputs are made empty with the launch's shapes and dtypes, and
the call's launches and work (each kernel's ``ops.work``) go into the
active :class:`Tally` -- never into a wrapper's ``LAUNCHES``, and never
through ``_lib()`` or a data pointer.  A fake operand with no tally
recording raises."""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

# element type codes of the C interfaces: 0 float32, 1 bfloat16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check(t: torch.Tensor, name: str, shape, dtype, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` (on ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA "
                         f"tensors")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def element_type(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel runs "
                         f"float32 or bfloat16")
    return DTYPES[t.dtype]


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(lib, name: str, rc: int):
    """A C launcher returns 0 or the launch's cudaError_t; a refused
    launch never runs, and ``synchronize`` would not report it."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def declare_error_string(lib):
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def waves(blocks: int, per_sm: int, sms: int) -> int:
    """How many rounds of resident blocks a grid needs."""
    if per_sm < 1:
        raise ValueError(f"no block fits on an SM (per_sm={per_sm})")
    return -(-blocks // (per_sm * sms))


class Tally:
    """The kernel calls of one traced step: ``kernels[name]`` = {"launches",
    "flops", "bytes"}, FLOPs counted as ``FlopCounterMode`` counts the
    plain version's (the products' multiply-adds, 2 a pair) and bytes
    as each input read once and each output written once."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, int]] = {}

    def add(self, name: str, launches: int, flops: int, nbytes: int):
        row = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += launches
        row["flops"] += flops
        row["bytes"] += nbytes


_TALLY: Optional[Tally] = None


@contextlib.contextmanager
def recording(tally: Tally):
    """Shape-only kernel calls inside the block go into ``tally``."""
    global _TALLY
    prev, _TALLY = _TALLY, tally
    try:
        yield tally
    finally:
        _TALLY = prev


def shape_only(t: torch.Tensor) -> bool:
    """True for a fake ``cuda`` tensor: a dry run's operand."""
    return isinstance(t, FakeTensor) and t.device.type == "cuda"


def record(name: str, launches: int, work):
    """One shape-only call of kernel ``name``: ``launches`` as the real
    wrapper would count them, ``work`` its ``ops.work`` (flops, bytes)."""
    if _TALLY is None:
        raise RuntimeError(
            f"{name}: a fake CUDA operand outside a kernel tally; trace "
            f"under kernels.launch.recording (launch/dryrun.py)")
    _TALLY.add(name, launches, *work)
