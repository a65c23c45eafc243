"""Shape-only stand-ins for every (architecture x shape) cell (the port of
``repro.launch.input_specs``).

The reference's ``jax.eval_shape(init)`` and ``ShapeDtypeStruct``s are
here trees of ``FakeTensor``s: shapes, dtypes and a device, no storage
and no draw.  Each function builds its tree under the active
``FakeTensorMode`` (the dry run's), or under a mode of its own when none
is active.  ``params_specs`` runs the model's own ``init_params``, whose
initialisers take the shapes alone under a fake mode
(``nn.lecun_normal``, ``moe._expert_init``, ``lm._stack_init``): a real
draw is what it always was.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import fake_mode
from repro_torch.models import encdec, lm
from repro_torch.tree import leaves_with_path, tree_map


@contextlib.contextmanager
def _fake():
    active = fake_mode()
    if active is not None:
        yield active
        return
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        yield mode


def _model(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def params_specs(cfg: ModelConfig, device="cuda"):
    """The param tree of ``cfg`` on ``device``, shapes and dtypes only."""
    with _fake():
        gen = torch.Generator().manual_seed(0)
        tree = _model(cfg).init_params(gen, cfg, device="cpu")
        if torch.device(device).type == "cpu":
            return tree
        # made anew on the device: a copy to a card is an op a CPU-only
        # build of PyTorch refuses, even for a fake tensor
        return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                              device=device), tree)


def _frontend(cfg: ModelConfig, b: int, device) -> Dict[str, Any]:
    shape = (b, cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.family == "encdec":
        return {"frames": torch.empty(shape, dtype=cfg.cdtype,
                                      device=device)}
    if cfg.frontend == "patches":
        return {"patch_embeds": torch.empty(shape, dtype=cfg.cdtype,
                                            device=device)}
    return {}


def train_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="cuda") -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with _fake():
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device=device),
                 "labels": torch.empty((b, s), dtype=torch.int32,
                                       device=device)}
        batch.update(_frontend(cfg, b, device))
    return batch


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig,
                  device="cuda") -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with _fake():
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device=device)}
        batch.update(_frontend(cfg, b, device))
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, device="cuda"):
    with _fake():
        return _model(cfg).init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device=device)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 device="cuda") -> Dict[str, Any]:
    with _fake():
        return {"token": torch.empty((shape.global_batch,),
                                     dtype=torch.int32, device=device),
                "cache": cache_specs(cfg, shape, device)}


def n_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the shape-only tree: a routed
    expert weight counts ``top_k / n_experts`` of itself as active."""
    total = active = 0
    for path, leaf in leaves_with_path(params_specs(cfg, "cpu")):
        size = leaf.numel()
        total += size
        if cfg.moe and any(n in ("gate_w", "up_w", "down_w") for n in path):
            active += size * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += size
    return total, active
