"""Param bridge: a JAX param pytree, as numpy, to the port's params.

The port keeps the JAX pytree's layout, so the bridge is a leaf-by-leaf
copy.  Leaves may be numpy arrays or anything ``np.asarray`` accepts
(JAX arrays included, without this module importing JAX).  JAX bf16
leaves reach numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: they are viewed as uint16 and then as ``torch.bfloat16``, so the
bits are copied exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

_FLOATS = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.float16): torch.float16}


def leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.astype(np.int16, copy=True)
                                ).view(torch.bfloat16)
    if a.dtype in _FLOATS or np.issubdtype(a.dtype, np.integer) \
            or a.dtype == np.bool_:
        return torch.from_numpy(np.array(a, copy=True))
    raise TypeError(f"unsupported leaf dtype {a.dtype}")


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return leaf_from_numpy(tree).to(dev)


def params_to_numpy(tree: Any) -> Any:
    """The inverse; bf16 leaves come back as float32 (exact)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
