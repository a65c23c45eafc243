"""The collectives of the port's training path, as autograd functions over
a ``torch.distributed`` process group (the ``lax.psum`` / ``pmean`` /
``all_gather`` / ``all_to_all`` of the reference's ``shard_map`` bodies).

``dist.all_reduce`` has no gradient, and
``torch.distributed.nn.functional.all_reduce`` all-reduces in the
backward as well; a replicated computation wants Megatron's conjugate
pair instead:

  * :func:`copy_to` -- identity forward, all-reduce (sum) backward: where
    a value whole on every rank of ``group`` enters work that each rank
    does a part of, so each rank's gradient there is a partial one;
  * :func:`reduce_from` -- all-reduce (sum, or mean) forward, identity
    backward: where the ranks' parts are combined into a value that
    every rank then uses whole.

:func:`all_gather` and :func:`all_to_all` carry their transposes (a
reduce-scatter, the inverse all-to-all) as their backward.

``group`` None is a group of one: every function is then the identity
(or a stack of one).  The sums run in the tensor's own dtype, as
``lax.psum`` does.  Every group here is gloo (``serve_mesh.BACKEND``),
which takes CUDA tensors (staging them through the host itself) for
``all_reduce``, ``all_gather`` and ``all_to_all_single`` (not the list
form ``all_to_all``) in fp32 and bf16, but no int16; a bool tensor
travels as uint8.
"""

from __future__ import annotations

import torch

_WIRE = {torch.bool: torch.uint8}


def size(group) -> int:
    """The number of ranks in ``group`` (1 for None)."""
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def rank_in(group) -> int:
    """This process's index in ``group`` (0 for None)."""
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _wire(x: torch.Tensor) -> torch.Tensor:
    w = _WIRE.get(x.dtype)
    x = x.contiguous()
    return x.view(w) if w is not None else x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group order."""
    import torch.distributed as dist
    send = _wire(x)
    parts = [torch.empty_like(send) for _ in range(size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.stack(parts).view(x.dtype)


def _a2a(x: torch.Tensor, group, split_dim: int, concat_dim: int
         ) -> torch.Tensor:
    """The tiled all-to-all: ``x`` cut into n blocks along ``split_dim``,
    block j sent to rank j; the blocks received, in rank order, joined
    along ``concat_dim``."""
    import torch.distributed as dist
    n = size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim))
    wire = _wire(send)
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return torch.cat(recv.view(x.dtype).unbind(0), dim=concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        out = _all_reduce(x, group)
        return out / size(group) if mean else out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a gather: every rank's cotangent of this rank's
        # block, summed (a reduce-scatter, as an all-reduce and a slice)
        return _all_reduce(g, ctx.group)[rank_in(ctx.group)], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced (summed) over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """``x`` all-reduced over ``group`` (summed, or averaged with
    ``mean``, as ``lax.psum`` / ``pmean``); the gradient passes
    unchanged."""
    return x if group is None else _ReduceFrom.apply(x, group, mean)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group order, differentiable."""
    return x[None] if group is None else _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    the gradient takes the inverse all-to-all."""
    return x if group is None else _AllToAll.apply(x, group, split_dim,
                                                   concat_dim)


def all_reduce_(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """In place, outside autograd: ``x`` summed (or averaged) over
    ``group``; returns ``x``."""
    if group is None:
        return x
    import torch.distributed as dist
    dist.all_reduce(x, group=group)
    if mean:
        x.div_(size(group))
    return x
