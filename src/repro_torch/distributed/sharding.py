"""Sharding rules: parameter-path regexes -> logical axes -> mesh axes
(the port of ``repro.distributed.sharding``).

Parallelism recipe (the reference's):

  * ``dp``     batch axis           -> ("pod", "data")
  * ``fsdp``   weight input dims    -> ("data",)
  * ``tp``     heads / ffn / vocab  -> ("model",)  Megatron tensor parallel
  * ``expert`` MoE expert dim       -> ("model",)
  * ``sp``     long-context seq dim -> ("data",)

A placement is a tuple with one entry per dim of the array: None (the dim
is whole on every rank) or the mesh axes that split it, a name or a
tuple of names (the reference's ``PartitionSpec``, entry for entry, a
one-name tuple written as the name, as ``PartitionSpec`` writes it).
:func:`shard_of` cuts one rank's block of a placed array, and
:func:`join_blocks` gathers the blocks back over a world.

The training layouts (:func:`params_pspecs`, :func:`batch_pspec`,
:func:`cache_pspecs`, :func:`token_pspec`) are pure functions of the
leaves' shapes and the mesh's axis sizes: a mesh is any object with
``axis_names`` and a ``shape`` mapping, a world's ``serve_mesh.RankMesh``
or a :class:`MeshShape` (which may carry the reference's ``pod`` axis).
The port has no sharding objects: where the reference places an array
on a mesh (``params_shardings``), a rank holds its own block
(:func:`params_shardings` returns the blocks).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.tree import at, map_with_path, tree_map

Placement = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes alone, e.g. ``MeshShape(("pod",
    "data", "model"), (2, 2, 2))``: enough for the layouts, which depend
    on nothing else."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def _entry(axes):
    """A placement entry as ``PartitionSpec`` keeps it: a one-name tuple
    is the name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def logical_mapping(mesh, pure_dp: bool = False
                    ) -> Dict[str, Tuple[str, ...]]:
    """pure_dp: the small-model layout -- every mesh axis is data
    parallelism, weights replicated."""
    has_pod = "pod" in mesh.axis_names
    if pure_dp:
        axes = ("pod", "data", "model") if has_pod else ("data", "model")
        return {"dp": axes, "fsdp": (), "tp": (), "expert": (), "sp": ()}
    return {
        "dp": ("pod", "data") if has_pod else ("data",),
        "fsdp": ("data",),
        "tp": ("model",),
        "expert": ("model",),
        "sp": ("data",),
    }


# first match wins; dims given WITHOUT the stacked-layer leading axis (it
# is prepended for the stacked layer params)
PARAM_RULES: List[Tuple[str, Optional[Tuple[Optional[str], ...]]]] = [
    # embeddings: vocab-parallel (Megatron)
    (r"embed/table$", ("tp", None)),
    (r"unembed/kernel$", (None, "tp")),
    (r"(patch_proj|frame_proj)/kernel$", (None, "tp")),
    (r"(enc_pos|dec_pos)/table$", (None, None)),
    # MoE experts (E, d_in, d_out)
    (r"(gate_w|up_w)/kernel$", ("expert", "fsdp", None)),
    (r"down_w/kernel$", ("expert", None, "fsdp")),
    (r"router/kernel$", (None, None)),
    # MLA
    (r"wq_a/kernel$", ("fsdp", None)),
    (r"wq_b/kernel$", (None, "tp")),
    (r"wkv_a/kernel$", ("fsdp", None)),
    (r"w[kv]_b/kernel$", (None, "tp")),
    # attention / minRNN cell / generic projections
    (r"(wq|wk|wv)/kernel$", ("fsdp", "tp")),
    (r"wo/kernel$", ("tp", "fsdp")),
    (r"rnn/w[zhfi]/kernel$", ("fsdp", "tp")),
    (r"rnn/w[zhfi]/bias$", ("tp",)),
    # MLP family (the paper block's mlp_in / mlp_out included)
    (r"(gate|up|mlp_in|in_proj)/kernel$", ("fsdp", "tp")),
    (r"(down|mlp_out|out_proj)/kernel$", ("tp", "fsdp")),
    (r"(gate|up|mlp_in|in_proj)/bias$", ("tp",)),
    # depthwise conv (K, D)
    (r"conv/kernel$", (None, "tp")),
    (r"conv/bias$", ("tp",)),
    # SSD per-head params
    (r"(a_log|dt_bias|d_skip)$", ("tp",)),
    # everything else (norms, small biases): replicated
    (r".*", None),
]


def _path_str(path) -> str:
    """A tree path (``tree.leaves_with_path``'s key tuple) as the
    reference's "a/b/c" string."""
    return "/".join(str(p) for p in path)


def _axes_size(mesh, phys: Tuple[str, ...]) -> int:
    n = 1
    for a in phys:
        n *= mesh.shape[a]
    return n


def spec_for_param(path: str, shape: Tuple[int, ...], mesh,
                   mapping: Dict[str, Tuple[str, ...]]) -> Placement:
    """The first matching rule's placement; a dim that its mesh axes do
    not divide stays whole (the reference's jit in_shardings need exact
    tiling; the port keeps the same layouts)."""
    ndim = len(shape)
    for pattern, logical in PARAM_RULES:
        if re.search(pattern, path):
            if logical is None:
                return (None,) * ndim
            axes: List[Any] = [None] * ndim
            offset = ndim - len(logical)      # leading stacked-layer dims
            if offset < 0:                    # rule longer than array: skip
                continue
            for i, name in enumerate(logical):
                if name is None:
                    continue
                phys = mapping[name]
                if not phys:                  # axis disabled (pure_dp)
                    continue
                if shape[offset + i] % _axes_size(mesh, phys) != 0:
                    continue                  # non-divisible -> whole
                axes[offset + i] = phys if len(phys) > 1 else phys[0]
            return tuple(axes)
    return (None,) * ndim


def params_pspecs(params, mesh, pure_dp: bool = False):
    """params (tensors, or anything with a ``shape``) -> the tree of their
    placements."""
    mapping = logical_mapping(mesh, pure_dp)
    return map_with_path(
        lambda path, leaf: spec_for_param(_path_str(path), tuple(leaf.shape),
                                          mesh, mapping), params)


def params_shardings(params, mesh, pure_dp: bool = False):
    """This rank's block of every leaf of ``params`` under
    :func:`params_pspecs` (``mesh`` a ``RankMesh``: its ``coords`` pick
    the block), each split leaf a contiguous copy."""
    specs = params_pspecs(params, mesh, pure_dp)
    return map_with_path(
        lambda path, leaf: shard_of(leaf, at(specs, path), mesh,
                                    mesh.coords), params)


def _dp(mesh, pure_dp: bool = False):
    return _entry(logical_mapping(mesh, pure_dp)["dp"])


def batch_pspec(mesh, batch: Dict[str, Any], pure_dp: bool = False):
    """Training / prefill batch: the leading batch dim over dp."""
    dp = _dp(mesh, pure_dp)
    return tree_map(lambda leaf: (dp,) + (None,) * (len(leaf.shape) - 1),
                    batch)


def cache_pspecs(cfg, mesh, cache, batch_size: int):
    """Decode caches.

    Attention kv caches shard their LENGTH dim over ``model`` (uniform
    across GQA / MQA / MLA head counts); batch over dp.  Long-context
    bs=1 cells additionally shard length over ``data`` (sequence
    parallel).  A dim its axes do not divide stays whole."""
    mapping = logical_mapping(mesh)
    dp = mapping["dp"]
    batch_sharded = batch_size % _axes_size(mesh, dp) == 0 \
        and batch_size >= _axes_size(mesh, dp)
    bdim = _entry(dp) if batch_sharded else None
    # length dim: model always; + data when batch is unsharded (long ctx)
    sdim = "model" if batch_sharded else ("data", "model")

    def _div(leaf, dim, axes):
        if axes is None:
            return None
        ax = (axes,) if isinstance(axes, str) else axes
        return axes if leaf.shape[dim] % _axes_size(mesh, ax) == 0 else None

    def spec(key, leaf):
        nd = len(leaf.shape)
        if key == "pos":
            return (_div(leaf, 0, bdim),)
        if key in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S, KV, hd)
            return (None, _div(leaf, 1, bdim), _div(leaf, 2, sdim),
                    None, None)
        if key in ("ckv", "krope"):
            # (L, B, S, latent)
            return (None, _div(leaf, 1, bdim), _div(leaf, 2, sdim), None)
        if key == "ssm":
            # (L, B, H, P, N)
            return (None, _div(leaf, 1, bdim), _div(leaf, 2, "model"),
                    None, None)
        if key == "conv":
            # (L, B, K-1, D)
            return (None, _div(leaf, 1, bdim), None, _div(leaf, 3, "model"))
        if key == "h":
            # (L, B, dh)
            return (None, _div(leaf, 1, bdim), _div(leaf, 2, "model"))
        return (None,) * nd

    return {k: tree_map(lambda l, kk=k: spec(kk, l), v)
            for k, v in cache.items()}


def token_pspec(mesh, batch_size: int) -> Placement:
    dp = logical_mapping(mesh)["dp"]
    n = _axes_size(mesh, dp)
    return (_entry(dp),) if batch_size % n == 0 and batch_size >= n \
        else (None,)


def _names(p) -> Tuple[str, ...]:
    return (p,) if isinstance(p, str) else tuple(p)


def shard_of(a: torch.Tensor, placement: Placement, mesh,
             coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``a`` that the rank at mesh ``coords`` (axis name ->
    index) holds under ``placement``, as a contiguous copy: a column block
    is a strided view, and the kernels' bindings assume dense rows.  A dim
    split over several axes takes the block of their row-major index, as
    a JAX sharding does.  A placement with no split dim returns ``a``
    itself; a dim its axes do not divide raises."""
    if all(p is None for p in placement):
        return a
    for dim, p in enumerate(placement):
        if p is None:
            continue
        names = _names(p)
        idx = 0
        for name in names:
            idx = idx * mesh.shape[name] + coords[name]
        n = _axes_size(mesh, names)
        if a.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(a.shape)} does not split "
                             f"over {p!r} ({n} blocks)")
        size = a.shape[dim] // n
        a = a.narrow(dim, idx * size, size)
    return a.clone(memory_format=torch.contiguous_format)


def join_blocks(block: torch.Tensor, placement: Placement, mesh
                ) -> torch.Tensor:
    """The inverse of :func:`shard_of` over a world (``mesh`` a
    ``RankMesh``): every rank's block of a placed array gathered into the
    whole, on every rank, bit for bit (bf16 travels as its bits).
    Collective over the groups of the split axes: every rank calls it
    with the same placement."""
    from repro_torch.distributed import collectives
    groups = {"data": mesh.data_group, "model": mesh.model_group}
    out = block
    for dim, p in enumerate(placement):
        if p is None:
            continue
        names = _names(p)
        if len(names) > 1:
            # a dim over several axes: its blocks in row-major order
            # over them, which is world rank order on a data x model mesh
            if tuple(names) != ("data", "model"):
                raise ValueError(f"join_blocks: dim {dim} over {names}")
            import torch.distributed as dist
            parts = collectives._gather(out, dist.group.WORLD)
        else:
            parts = collectives._gather(out, groups[names[0]]) \
                if mesh.shape[names[0]] > 1 else out[None]
        out = torch.cat(parts.unbind(0), dim=dim)
    return out
