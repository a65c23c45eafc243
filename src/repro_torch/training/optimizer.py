"""AdamW with global-norm clipping and warmup + cosine / linear /
constant schedules (``repro.training.optimizer``).

The state mirrors the params: ``AdamWState(step, mu, nu)`` with ``mu`` /
``nu`` nested dicts of the params' layout (fp32, or bf16 moments).  The
update math runs in fp32 and the result is cast back to each param's
dtype, as in the reference.

Unlike the reference, ``apply`` updates in place: the param and moment
tensors are overwritten under ``torch.no_grad()`` (no second copy of a
model's weights and moments), and the same dicts come back.  A caller
that needs the old values keeps a copy.  A leaf is updated in slices of
its leading axis of at most ``_SLICE_ELEMS`` elements: the update is
elementwise, so the values are the same, and the fp32 temporaries of a
stacked leaf of zamba2-2.7b's (1.44 B elements, 5.8 GB each in fp32) do
not all sit on the card at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map

_NO_DECAY = ("scale", "bias", "a_log", "dt_bias", "d_skip")
# the most elements of a leaf one slice of the update holds in fp32
_SLICE_ELEMS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # "bfloat16" halves moment memory
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"             # cosine | constant | linear


class AdamWState(NamedTuple):
    step: torch.Tensor                   # int32 scalar
    mu: Any
    nu: Any


def decay_mask(path, leaf) -> float:
    """No weight decay on norms / biases / 1-d params."""
    if leaf.ndim <= 1:
        return 0.0
    if any(n in _NO_DECAY for n in path):
        return 0.0
    return 1.0


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (1-based after the first update),
    in fp32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:                                 # cosine
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init(cfg: AdamWConfig, params) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params, grads,
          grad_norm=None) -> tuple:
    """One AdamW update, in place (see the module docstring).  ``grads``
    has the params' layout.  ``grad_norm``: the global norm to clip by,
    where ``grads`` is one rank's block of a tree split over a mesh
    (default: ``global_norm(grads)``).  Returns (params, new_state,
    metrics)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    step = state.step + 1
    lr = schedule_lr(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    for (path, p), g, mu, nu in zip(leaves_with_path(params), leaves(grads),
                                    leaves(state.mu), leaves(state.nu)):
        wd = decay_mask(path, p)
        # a leaf of an empty layer stack (n_layers ==
        # first_dense_layers) has no slice, and nothing to update
        rows = max(1, _SLICE_ELEMS // max(1, p[0].numel())) \
            if p.ndim and p.shape[0] else 1
        for i in range(0, p.shape[0] if p.ndim else 1, rows):
            sl = slice(i, i + rows) if p.ndim else ...
            _update(cfg, p[sl], g[sl], mu[sl], nu[sl], scale, lr, bc1, bc2,
                    wd)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics


def _update(cfg, p, g, mu, nu, scale, lr, bc1, bc2, wd):
    """The AdamW update of one leaf or slice, in place."""
    b1, b2 = cfg.b1, cfg.b2
    if scale is not None:
        g = g * scale.to(g.dtype)
    g32 = g.float()
    mu32 = b1 * mu.float() + (1 - b1) * g32
    nu32 = b2 * nu.float() + (1 - b2) * g32 * g32
    delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
    if wd:
        delta = delta + cfg.weight_decay * wd * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
    mu.copy_(mu32.to(mu.dtype))
    nu.copy_(nu32.to(nu.dtype))
