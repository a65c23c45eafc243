"""Train-step builders (``repro.training.train_step``).

  * ``make_train_step`` -- loss -> grads (``torch.autograd.grad`` over the
    params' floating leaves) -> AdamW, with optional microbatch
    accumulation in fp32.  The step runs eagerly on the params' device;
    the AdamW update is in place (``optimizer.apply``).
  * ``make_dp_compressed_step`` -- the explicit data-parallel step on one
    rank of a data x model world (``serve_mesh.RankMesh``): grads of this
    rank's slice of the batch, cast to ``grad_dtype`` (bf16: half the
    bytes), averaged over the data group in one flattened all-reduce,
    then AdamW on the replicated params.  The model ranks compute the
    same step redundantly, as the reference's do.
  * ``make_mesh_train_step`` -- one rank's step of an MoE model trained
    expert parallel (``moe.expert_placements``): the reference runs
    ``make_train_step`` under ``use_mesh`` on sharded params and lets
    XLA place the collectives; here the rank's loss runs under
    ``use_mesh``, whose MoE layers carry their own collectives, and the
    step reduces the grads and the global norm over the mesh.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding
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


def _rank_batch(batch, mesh, dev):
    """This rank's block of the global batch: dim 0 over the data ranks."""
    return {k: sharding.shard_of(v, ("data",) + (None,) * (v.dim() - 1),
                                 mesh, mesh.coords)
            for k, v in batch_to(batch, dev).items()}


def _mean_metrics(metrics, group):
    """The metrics averaged over ``group``, as ``lax.pmean`` does."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float() for k in keys])
    collectives.all_reduce_(vals, group, mean=True)
    return dict(zip(keys, vals.unbind(0)))


def _bucket_mean(tensors, group, dtype):
    """Each tensor cast to ``dtype`` and averaged over ``group``: one
    flattened all-reduce (the same per-element sums as an all-reduce a
    leaf), then the division by the group's size in ``dtype``, as
    ``lax.pmean`` does."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    collectives.all_reduce_(flat, group)
    flat = flat / collectives.size(group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def make_dp_compressed_step(cfg, opt_cfg: opt_lib.AdamWConfig, mesh, *,
                            grad_dtype=torch.bfloat16) -> Callable:
    """Explicit data-parallel step on one rank of ``mesh`` (this rank's
    ``serve_mesh.RankMesh``):
    ``step(params, opt_state, batch)`` with the global batch (dim 0 split
    over the data ranks) and the replicated params.  The grads are cast
    to ``grad_dtype`` before the data group's all-reduce (the gradient
    compression), averaged, and AdamW applies them in fp32; the metrics
    are averaged the same way.  Every rank of a data group applies the
    same averaged grads, so replicas stay equal; model ranks repeat
    their row's step."""
    loss_fn = make_loss_fn(cfg)

    def step(params, opt_state, batch):
        dev = leaves(params)[0].device
        (_, metrics), grads = value_and_grad(
            loss_fn, params, _rank_batch(batch, mesh, dev))
        # the compression boundary: the only traffic between ranks
        grads = unflatten(params, _bucket_mean(leaves(grads),
                                               mesh.data_group, grad_dtype))
        metrics = _mean_metrics(metrics, mesh.data_group)
        params, opt_state, om = opt_lib.apply(opt_cfg, opt_state, params,
                                              grads)
        metrics.update(om)
        return params, opt_state, metrics

    return step


def _split_axes(placement):
    out = set()
    for p in placement:
        if p is not None:
            out.update((p,) if isinstance(p, str) else p)
    return frozenset(out)


def mesh_value_and_grad(cfg, mesh, placements, params, batch):
    """One rank's (metrics, grads, global grad norm) of the global batch
    on ``mesh``: ``params`` are this rank's blocks under ``placements``
    (``moe.expert_placements``).  The loss of this rank's slice runs
    under ``use_mesh(mesh)``.  A leaf whole on the data ranks has its
    grads averaged over them, in their dtype; a block split over them
    (2D experts) holds the grad of the ranks' summed losses
    (``models/moe.py``), divided by their number here: both are then the
    grads of the mean of the data ranks' losses, the global batch's
    loss.  The norm sums each leaf's squares once over the mesh."""
    loss_fn = make_loss_fn(cfg)
    dev = leaves(params)[0].device
    with mesh_ctx.use_mesh(mesh):
        (_, metrics), grads = value_and_grad(
            loss_fn, params, _rank_batch(batch, mesh, dev))
    n_data = mesh.shape["data"]
    specs = leaves(placements)
    gl = leaves(grads)
    whole = [i for i, s in enumerate(specs) if "data" not in _split_axes(s)]
    for dt in sorted({gl[i].dtype for i in whole}, key=str):
        idx = [i for i in whole if gl[i].dtype == dt]
        for i, g in zip(idx, _bucket_mean([gl[i] for i in idx],
                                          mesh.data_group, dt)):
            gl[i] = g
    for i, s in enumerate(specs):
        if "data" in _split_axes(s):
            gl[i] = gl[i] / n_data
    # the global norm: each axis set's squares summed over its groups
    groups = {"data": mesh.data_group, "model": mesh.model_group}
    parts = {}
    for s, g in zip(specs, gl):
        axes = _split_axes(s)
        parts[axes] = parts.get(axes, 0.0) + torch.sum(torch.square(
            g.float()))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes, sq in parts.items():
        sq = torch.as_tensor(sq, dtype=torch.float32, device=dev).clone()
        for ax in sorted(axes):
            collectives.all_reduce_(sq, groups[ax])
        total = total + sq
    return (_mean_metrics(metrics, mesh.data_group), unflatten(params, gl),
            torch.sqrt(total))


def make_mesh_train_step(cfg, opt_cfg: opt_lib.AdamWConfig, mesh,
                         placements) -> Callable:
    """One rank's train step of a model whose params are split over
    ``mesh`` by ``placements`` (``moe.expert_placements`` of the
    ``moe.ep_layout`` for the batch's tokens a rank):
    ``step(params, opt_state, batch)`` with this rank's blocks of the
    params and moments and the global batch.  Grads and norm from
    :func:`mesh_value_and_grad`; AdamW clips by the mesh's global norm."""

    def step(params, opt_state, batch):
        metrics, grads, gnorm = mesh_value_and_grad(cfg, mesh, placements,
                                                    params, batch)
        params, opt_state, om = opt_lib.apply(opt_cfg, opt_state, params,
                                              grads, grad_norm=gnorm)
        metrics.update(om)
        return params, opt_state, metrics

    return step
