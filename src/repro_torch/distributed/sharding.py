"""Sharding rules: parameter-path regexes -> logical axes -> mesh axes
(the part of ``repro.distributed.sharding`` that serving needs).

Parallelism recipe (the reference's):

  * ``dp``     batch axis           -> ("pod", "data")
  * ``fsdp``   weight input dims    -> ("data",)
  * ``tp``     heads / ffn / vocab  -> ("model",)  Megatron tensor parallel
  * ``expert`` MoE expert dim       -> ("model",)
  * ``sp``     long-context seq dim -> ("data",)

A placement is a tuple with one entry per dim of the array: None (the dim
is whole on every rank) or the mesh axes that split it, a name or a
tuple of names (the reference's ``PartitionSpec``).  :func:`shard_of`
cuts one rank's block of a placed array.  The training layouts
(``params_pspecs``, ``batch_pspec``, ``cache_pspecs``, ``token_pspec``)
wait for the training half of ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

Placement = Tuple[Any, ...]


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


def shard_of(a: torch.Tensor, placement: Placement, mesh,
             coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``a`` that the rank at mesh ``coords`` (axis name ->
    index) holds under ``placement``, as a contiguous copy: a column block
    is a strided view, and the kernels' bindings assume dense rows.  A dim
    split over several axes takes the block of their row-major index, as
    a JAX sharding does.  A placement with no split dim returns ``a``
    itself."""
    if all(p is None for p in placement):
        return a
    for dim, p in enumerate(placement):
        if p is None:
            continue
        names = (p,) if isinstance(p, str) else tuple(p)
        idx = 0
        for name in names:
            idx = idx * mesh.shape[name] + coords[name]
        size = a.shape[dim] // _axes_size(mesh, names)
        a = a.narrow(dim, idx * size, size)
    return a.clone(memory_format=torch.contiguous_format)
