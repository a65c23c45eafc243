"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Params, optimizer moments and grads are plain nested dicts whose leaves
are tensors, in the JAX pytree's layout.  Every walk visits the keys in
their dict order, so two trees of one layout line up leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

import torch


def leaves_with_path(tree, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(like, new_leaves: Sequence[Any]):
    """A tree of ``like``'s layout holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), like)


def stack(trees: Sequence[Any]):
    """Trees of one layout -> one tree whose leaves are the trees' leaves
    stacked on a new leading axis (the reference's ``vmap``-ed inits)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))
