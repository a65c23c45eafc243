"""What every ctypes kernel wrapper of the port shares: the operand checks
made before a pointer is handed to C, the current stream, turning a
returned CUDA status into an exception, and the waves a grid needs.  Nothing here touches a GPU at
import time."""

from __future__ import annotations

import ctypes

import torch

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
