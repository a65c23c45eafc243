"""Train-step builder (``repro.training.train_step.make_train_step``).

loss -> grads (``torch.autograd.grad`` over the params' floating leaves)
-> AdamW, with optional microbatch accumulation in fp32.  The step runs
eagerly on the params' device; the AdamW update is in place
(``optimizer.apply``).  The reference's ``make_dp_compressed_step``
(bf16 gradient all-reduce over a data-parallel mesh) waits for
``torch.distributed`` (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.models import encdec, lm
from repro_torch.training import optimizer as opt_lib
from repro_torch.tree import leaves, unflatten


def model_for(cfg):
    """The model module of ``cfg``: ``encdec`` for an encoder-decoder,
    else ``lm``."""
    return encdec if cfg.family == "encdec" else lm


def make_loss_fn(cfg):
    model = model_for(cfg)

    def loss(params, batch):
        return model.loss_fn(params, cfg, batch)

    return loss


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device) for k, v in batch.items()}


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics), grads with the params' layout and dtypes."""
    flat = leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    # a leaf the loss does not read (pixtral-12b's patch projection on a
    # text batch) gets zeros, as ``jax.grad`` gives it
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), metrics), unflatten(params, grads)


def make_train_step(cfg, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``params`` is the nested dict of floating tensors (made
    trainable here if they are not); the update overwrites it in place.
    With ``microbatches`` > 1 the batch is split along dim 0 and the
    grads are summed in fp32 and averaged, as the reference's scan does."""
    loss_fn = make_loss_fn(cfg)

    def single(params, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        return grads, metrics

    def accumulated(params, batch):
        acc, all_metrics = None, []
        for m in range(microbatches):
            micro = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))[m]
                     for k, v in batch.items()}
            grads, metrics = single(params, micro)
            g32 = [g.float() for g in leaves(grads)]
            acc = g32 if acc is None else [a + g for a, g in zip(acc, g32)]
            all_metrics.append(metrics)
        grads = unflatten(params, [a / microbatches for a in acc])
        metrics = {k: torch.stack([m_[k] for m_ in all_metrics]).mean()
                   for k in all_metrics[0]}
        return grads, metrics

    def train_step(params, opt_state, batch):
        dev = leaves(params)[0].device
        batch = batch_to(batch, dev)
        if microbatches > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = single(params, batch)
        params, opt_state, om = opt_lib.apply(opt_cfg, opt_state, params,
                                              grads)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
