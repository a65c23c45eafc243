"""Mesh-sharded serving: the slot pool over ``data``, the minRNN gate,
``down`` and MLP projections over ``model`` (the port of
``repro.distributed.serve_mesh``).

The reference runs one host process over a ``data x model`` device mesh
(``shard_map``).  The port runs one process per mesh position, SPMD, as
``torch.distributed`` does: rank r sits at ``(r // model, r % model)``.
Its process groups are one *model group* per data row (the ranks that
share a row block of the slot pool; it carries the tensor-parallel
all-reduces) and one *data group* per model column (it carries the host
planes at each drain).  Every group is gloo: on the CPU, and on one card,
where every rank shares ``cuda:0`` and NCCL cannot place two ranks.

Every rank runs the same ``ServingEngine`` host logic on the same
submissions; the scheduler and the fault injector are seeded, so every
host decides alike as long as it reads the same planes.  So at each
drain a rank gathers its data shard's ``toks`` / ``rids`` / non-finite
flags and counters over its data group (the reference's ``(B, K[, S+1])``
planes and its ``(data,)`` counters), and under tensor parallelism the
planes of model rank 0 are broadcast over the model group
(:meth:`RankMesh.gather`); the engine counts any element where a rank's
own planes differed.

**Data parallelism.**  The superstep's body is per-slot arithmetic: a
rank runs ``lm.superstep`` on its ``B/data`` rows with no collective, and
a row's bits do not depend on its shard.  A rank's slot state is cut
from the global ``B``-row state (:func:`cut_slot_state`), never made at
``B/data``: the per-slot PRNG keys depend on the global row.

**Tensor parallelism.**  The gate kernels and ``mlp_in`` are split by
column, ``down`` and ``mlp_out`` by row (:func:`shard_params`, each block
a contiguous copy); each rank's cell kernels run on its ``d_hidden /
model`` column block, and the row-parallel products all-reduce their
partials over the model group (``blocks._row_parallel_apply``): one
reduction per mixer sub-block and one per MLP.  The residual stream,
norms, conv and the embedding stay whole on every rank, so sampling sees
whole logits with no collective.  Splitting the ``down`` contraction
reorders its sum: fp32 streams stay argmax-equal, bf16 ones part at near
ties (the reference's caveat).  The health guard reads a rank's own
``h`` block; injected NaN faults poison whole rows on every model rank,
so every rank agrees.

**Failover.**  A "crashed" data shard stays in the world; the engine
marks its rows (:func:`shard_rows`) dead for good, they keep stepping as
wasted slot-steps, and its requests finish on the survivors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import re
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding
from repro_torch.tree import map_with_path

BACKEND = "gloo"
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """``data`` x ``model`` serving mesh shape (the ``--mesh DxM`` flag).

    ``data`` splits the slot pool over B; ``model`` splits ``d_hidden`` /
    ``d_ff`` (each rank streams 1/model of the gate, down and MLP bytes a
    round and pays an all-reduce per sub-block)."""
    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got "
                             f"{self.data}x{self.model}")

    @classmethod
    def parse(cls, spec) -> Optional["MeshPlan"]:
        """``None`` | ``MeshPlan`` | ``"DxM"`` string -> MeshPlan or None."""
        if spec is None or isinstance(spec, cls):
            return spec
        m = re.fullmatch(r"(\d+)x(\d+)", str(spec).strip())
        if not m:
            raise ValueError(
                f"mesh spec must look like '4x1' or '2x2' "
                f"(data x model), got {spec!r}")
        return cls(int(m.group(1)), int(m.group(2)))

    @property
    def size(self) -> int:
        return self.data * self.model

    def build(self) -> "RankMesh":
        """This process's place in the mesh: its rank, coordinates and
        process groups.  The world must be initialised with ``size``
        ranks (one process per mesh position); a ``1x1`` plan also runs in
        one process with no world."""
        import torch.distributed as dist
        up = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if up else 1
        if world != self.size:
            have = f"the initialised world has {world} ranks" if up else \
                "torch.distributed is not initialised in this process"
            raise RuntimeError(
                f"mesh {self} needs {self.size} ranks, one process per "
                f"mesh position, but {have}.  Serve it with `python -m "
                f"repro_torch.launch.serve --mesh {self}` (which spawns the "
                f"ranks), or under `torchrun --nproc-per-node "
                f"{self.size} -m repro_torch.launch.serve --mesh {self}`; "
                f"code of your own runs each rank's engine inside "
                f"`serve_mesh.run_world(fn, {self.size})`")
        if world == 1:
            return RankMesh(self, 0)
        model_groups, data_groups = _groups(self)
        rank = dist.get_rank()
        return RankMesh(self, rank,
                        model_group=model_groups[rank // self.model],
                        data_group=data_groups[rank % self.model])

    def __str__(self) -> str:
        return f"{self.data}x{self.model}"


# process groups per (world, plan): ``dist.new_group`` is collective over
# the whole world, and an engine is built many times in one world
_GROUP_CACHE: Dict[Tuple[int, MeshPlan], Tuple[list, list]] = {}


def _groups(plan: MeshPlan):
    """(model group of each data row, data group of each model column);
    None where the axis has size 1.  Every rank creates every group, in
    the same order, as ``new_group`` requires."""
    import torch.distributed as dist
    key = (id(dist.group.WORLD), plan)
    if key not in _GROUP_CACHE:
        d, m = plan.data, plan.model
        rows = [dist.new_group([r * m + j for j in range(m)],
                               backend=BACKEND, timeout=TIMEOUT)
                if m > 1 else None for r in range(d)]
        cols = [dist.new_group([i * m + c for i in range(d)],
                               backend=BACKEND, timeout=TIMEOUT)
                if d > 1 else None for c in range(m)]
        _GROUP_CACHE[key] = (rows, cols)
    return _GROUP_CACHE[key]


@dataclasses.dataclass
class RankMesh:
    """One rank's view of a built serving mesh."""
    plan: MeshPlan
    rank: int
    model_group: Any = None     # this rank's data row; None at model 1
    data_group: Any = None      # this rank's model column; None at data 1
    axis_names = ("data", "model")

    @property
    def data_index(self) -> int:
        return self.rank // self.plan.model

    @property
    def model_index(self) -> int:
        return self.rank % self.plan.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.plan.data, "model": self.plan.model}

    @property
    def coords(self) -> Dict[str, int]:
        return {"data": self.data_index, "model": self.model_index}

    def gather(self, flat: torch.Tensor) -> Tuple[np.ndarray, int]:
        """flat: this rank's (n,) CPU vector of host planes -> ((data, n)
        array, every data shard's vector in shard order, as model rank 0
        of this rank's row gathered them; the number of elements where
        this rank's own gather differed from model rank 0's)."""
        import torch.distributed as dist
        if self.data_group is not None:
            parts = [torch.empty_like(flat) for _ in range(self.plan.data)]
            dist.all_gather(parts, flat, group=self.data_group)
            out = torch.stack(parts)
        else:
            out = flat[None].clone()
        mismatches = 0
        if self.model_group is not None:
            own = out.clone()
            dist.broadcast(out, src=self.data_index * self.plan.model,
                           group=self.model_group)
            mismatches = int((own != out).sum())
        return out.numpy(), mismatches

    def barrier(self):
        import torch.distributed as dist
        if self.plan.size > 1:
            dist.barrier()


def shard_rows(shard: int, rows_per_shard: int) -> range:
    """Contiguous slot rows owned by data shard ``shard`` (ownership is
    ``slot // rows_per_shard`` everywhere: staging placement, per-shard
    counters and the failover drain all agree on this map)."""
    return range(shard * rows_per_shard, (shard + 1) * rows_per_shard)


# ---------------------------------------------------------------------------
# The slot state and the serving params, cut per rank
# ---------------------------------------------------------------------------

def _tp_shards_hidden(cfg, plan: MeshPlan) -> bool:
    """True when the model axis splits ``d_hidden`` -- the same rule as
    ``sharding.spec_for_param``'s divisibility fallback, so the h cache's
    layout agrees with the gate kernels'."""
    if plan.model <= 1 or cfg.block_kind != "minrnn":
        return False
    d_hidden = int(cfg.d_model * (cfg.minrnn.expansion if cfg.minrnn
                                  else 1.0))
    return d_hidden % plan.model == 0


def _slot_axes(path: Tuple[str, ...], shard_hidden: bool
               ) -> Tuple[int, Optional[int]]:
    """(batch axis, model-split axis or None) of a slot-state leaf.  Cache
    leaves are (L, B, ...) with ``pos`` (B,); only the minRNN ``h`` leaf
    carries a model dim (it is the column-parallel gate output); a draft
    model's cache splits over ``data`` only (its weights are whole on
    every rank).  Every other leaf is batch-leading."""
    if path[0] in ("cache", "draft_cache"):
        if path[-1] == "pos":
            return 0, None
        hidden = path[0] == "cache" and path[-1] == "h" and shard_hidden
        return 1, (2 if hidden else None)
    return 0, None


def cut_slot_state(cfg, state: Dict[str, Any], mesh: RankMesh
                   ) -> Dict[str, Any]:
    """This rank's shard of the global ``B``-row slot state: rows
    ``shard_rows(data_index, B / data)`` of every leaf, and under TP this
    rank's column block of ``h``; each a contiguous copy on the leaf's
    device."""
    plan = mesh.plan
    hidden = _tp_shards_hidden(cfg, plan)

    def cut(path, leaf):
        b_ax, m_ax = _slot_axes(path, hidden)
        placement = [None] * leaf.dim()
        placement[b_ax] = "data"
        if m_ax is not None:
            placement[m_ax] = "model"
        return sharding.shard_of(leaf, tuple(placement), mesh, mesh.coords)

    return map_with_path(cut, state)


def join_slot_state(cfg, state: Dict[str, Any], mesh: RankMesh
                    ) -> Dict[str, Any]:
    """The inverse of :func:`cut_slot_state`: every rank's shard gathered
    into the global slot state, as CPU tensors on every rank.  Collective:
    every rank calls it."""
    import torch.distributed as dist
    hidden = _tp_shards_hidden(cfg, mesh.plan)

    def gather(t: torch.Tensor, axis: int, group, n: int) -> torch.Tensor:
        # bool travels as uint8; bf16 and fp16 as themselves (gloo on
        # torch 2.11 refuses int16: "Invalid scalar type")
        wire = {torch.bool: torch.uint8}.get(t.dtype)
        send = (t.view(wire) if wire is not None else t).contiguous()
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        out = torch.cat(parts, dim=axis)
        return out.view(t.dtype) if wire is not None else out

    def join(path, leaf):
        b_ax, m_ax = _slot_axes(path, hidden)
        t = leaf.detach().cpu()
        if m_ax is not None and mesh.model_group is not None:
            t = gather(t, m_ax, mesh.model_group, mesh.plan.model)
        if mesh.data_group is not None:
            t = gather(t, b_ax, mesh.data_group, mesh.plan.data)
        return t

    return map_with_path(join, state)


# Serving-TP whitelist: ONLY the projections whose d_hidden / d_ff dim the
# decode path blocks over (column-parallel gates + mlp_in, row-parallel
# down + mlp_out).  Norms, the depthwise conv (its channels feed the whole
# d_model gate contraction) and the embedding stay whole on every rank,
# even where the training PARAM_RULES would split them.
_SERVE_TP_PARAMS = re.compile(
    r"(rnn/w[zhfi]/(kernel|bias)|down/kernel"
    r"|mlp_in/(kernel|bias)|mlp_out/kernel)$")


def serve_params_pspecs(params, cfg, mesh: RankMesh):
    """Placements of the serving params: whole under pure DP; under TP the
    ``sharding.PARAM_RULES`` entries for the gate / down / MLP projections
    with ``tp -> ("model",)`` and every other logical axis off (``fsdp``
    and the rest are training layouts: serving wants whole weights per
    data shard)."""
    return map_with_path(lambda path, leaf: _serve_spec(path, leaf, mesh),
                          params)


def _serve_spec(path, leaf, mesh: RankMesh) -> sharding.Placement:
    path_s = sharding._path_str(path)
    if mesh.plan.model <= 1 or not _SERVE_TP_PARAMS.search(path_s):
        return (None,) * leaf.dim()
    mapping = {"dp": (), "fsdp": (), "tp": ("model",), "expert": (),
               "sp": ()}
    return sharding.spec_for_param(path_s, tuple(leaf.shape), mesh, mapping)


def shard_params(params, cfg, mesh: RankMesh):
    """This rank's serving params: each split leaf's block as a contiguous
    copy (the cell kernels' bindings assume dense rows and 16-byte aligned
    weights), every other leaf as it is."""
    return map_with_path(
        lambda path, leaf: sharding.shard_of(
            leaf, _serve_spec(path, leaf, mesh), mesh, mesh.coords), params)


# ---------------------------------------------------------------------------
# The superstep on one rank
# ---------------------------------------------------------------------------

def make_superstep(cfg, mesh: Optional[RankMesh], n: int, *,
                   prompt_chunk: int = 1, draft=None):
    """This rank's part of the reference's ``shard_map``-ed superstep:
    ``fn(params, draft_params, state, **kw) -> (toks, rids, state,
    counters)``, the local ``lm.superstep`` on the rank's rows (and its
    ``d_hidden`` column block under TP) inside ``serving_tp`` of its model
    group.  The counters are this data shard's; the engine's drain gathers
    them with the planes over the data group (:meth:`RankMesh.gather`),
    the reference's ``(data,)`` counter out-spec.  ``kw`` goes on to
    ``lm.superstep`` (``layers``, ``sampled``, ``chunk_rounds``)."""
    from repro_torch.models import lm       # deferred: no import cycle
    group = None if mesh is None else mesh.model_group

    def fn(params, draft_params, state, **kw):
        with mesh_ctx.serving_tp(group):
            return lm.superstep(params, cfg, state, n,
                                prompt_chunk=prompt_chunk, draft=draft,
                                draft_params=draft_params, **kw)

    return fn


# ---------------------------------------------------------------------------
# Ranks: spawned here, or joined under torchrun
# ---------------------------------------------------------------------------

def rank_device(device="cuda") -> torch.device:
    """A rank's device: ``cuda:{local_rank % device_count}`` for a CUDA
    request without an index (every rank on ``cuda:0`` on one card), the
    CPU when asked for, an indexed device as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        from repro_torch.device import resolve_device
        return resolve_device(dev)              # raises, naming the fix
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ \
        and "MASTER_ADDR" in os.environ


def run_world(fn: Callable, size: int, args: Sequence = ()) -> List[Any]:
    """Run ``fn(*args)`` once on every rank of a ``size``-rank gloo world
    and return the ranks' results in rank order.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set)
    this process is one rank: it joins the world and returns its own
    result alone.  Otherwise it spawns ``size`` processes
    (``torch.multiprocessing.spawn``) that meet at a ``file://``
    rendezvous in a temporary directory (no port to collide on); each
    runs one intra-op thread (the ranks are the parallelism) and writes
    its result there.  A rank that raises makes the others stop and this
    call raise.  ``fn`` must be importable by name: a module-level
    function of a module that imports no JAX."""
    import torch.distributed as dist
    if _under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != size:
            raise RuntimeError(
                f"torchrun started {os.environ['WORLD_SIZE']} ranks for a "
                f"world of {size}: pass --nproc-per-node {size}")
        if not dist.is_initialized():
            dist.init_process_group(BACKEND, timeout=TIMEOUT)
        return [fn(*args)]
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_world_") as d:
        mp.spawn(_rank_entry, args=(fn, size, d, tuple(args)),
                 nprocs=size, join=True)
        out = []
        for r in range(size):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_entry(rank: int, fn: Callable, size: int, tmp: str, args: tuple):
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(size))
    dist.init_process_group(
        BACKEND, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=size, timeout=TIMEOUT)
    try:
        result = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
