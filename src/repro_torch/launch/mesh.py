"""The production meshes of the multi-pod dry run (the port of
``repro.launch.mesh``), as ``sharding.MeshShape`` objects: the axis
names and sizes alone.  ``launch/dryrun.py`` plays one rank of a fake
world of that size; nothing here opens a world or touches a device.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 2, model: int = 2,
                    pod: int = 0) -> MeshShape:
    """A small mesh for the CPU tests."""
    if pod:
        return MeshShape(("pod", "data", "model"), (pod, data, model))
    return MeshShape(("data", "model"), (data, model))
