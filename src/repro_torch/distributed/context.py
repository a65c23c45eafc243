"""Mesh context: lets deep layers find the active mesh, and the serving
tensor-parallel group, without threading them through every apply()
signature (the port of ``repro.distributed.context``).

A mesh here is any object with ``axis_names`` and a ``shape`` mapping an
axis name to its size, as ``serve_mesh.RankMesh``.  The reference's
``shard_map`` wrapper has no counterpart: the port runs one process per
mesh position (``serve_mesh``), and the collectives are explicit
``torch.distributed`` calls over the rank's process groups.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_ACTIVE_MESH: Any = None
_PURE_DP: bool = False
_SERVING_TP_GROUP: Any = None


@contextlib.contextmanager
def use_mesh(mesh, pure_dp: bool = False):
    global _ACTIVE_MESH, _PURE_DP
    prev, prev_dp = _ACTIVE_MESH, _PURE_DP
    _ACTIVE_MESH, _PURE_DP = mesh, pure_dp
    try:
        yield mesh
    finally:
        _ACTIVE_MESH, _PURE_DP = prev, prev_dp


@contextlib.contextmanager
def serving_tp(group):
    """Mark the enclosed calls as running on one rank of a tensor-parallel
    serving group that shards ``d_hidden`` / ``d_ff`` weight blocks.
    Row-parallel projections (``blocks._row_parallel_apply``) read
    :func:`serving_tp_group` to decide whether their partial products need
    an all-reduce over ``group``.  ``None`` is inert (pure data
    parallelism / one device).  The previous group comes back on exit,
    an error included."""
    global _SERVING_TP_GROUP
    prev = _SERVING_TP_GROUP
    _SERVING_TP_GROUP = group
    try:
        yield group
    finally:
        _SERVING_TP_GROUP = prev


def serving_tp_group():
    """The reference's ``serving_tp_axis``: the process group the
    row-parallel projections reduce over, or None."""
    return _SERVING_TP_GROUP


def current_mesh():
    return _ACTIVE_MESH


def pure_dp() -> bool:
    return _PURE_DP


def dp_axes(mesh):
    """Data-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Optional[Any], name: str) -> int:
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
