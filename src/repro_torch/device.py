"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
Asking for CUDA where there is none raises: nothing falls back to the
CPU quietly.  Tests pass ``device="cpu"``.

The one exception is a trace on fake tensors (``launch/dryrun.py``):
under an active ``FakeTensorMode`` nothing runs, so a ``cuda`` device is
let through on a host without a card.
"""

from __future__ import annotations

import torch


def fake_mode():
    """The active ``FakeTensorMode``, or None."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, FakeTensorMode):
            return mode
    return None


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and fake_mode() is None:
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            f" is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
