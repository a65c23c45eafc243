"""What each rank of a CPU training world runs for the port's distributed
training tests (``test_torch_dp_training.py``,
``test_torch_expert_parallel.py``).

A test starts a world with ``serve_mesh.run_world(fn, size, args)``,
which spawns one process per rank; a rank imports this module by name,
so it imports torch and the port only -- no JAX, no test module.  Each
function runs every scenario of one world size in one world and returns
plain data (numpy arrays and floats).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import archs
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import scan as scan_lib
from repro_torch.distributed import serve_mesh, sharding
from repro_torch.models import moe
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib

# the reference's EP test config (tests/test_spmd.py)
EP_CFG = ModelConfig(d_model=16, moe=MoEConfig(
    n_experts=8, top_k=2, d_expert=32, capacity_factor=16.0))
DP_OPT = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")


def ep_cfg(mode: str) -> ModelConfig:
    return EP_CFG.replace(moe=dataclasses.replace(EP_CFG.moe, ep_2d=mode))


def _tensors(tree_np):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree_np)


def _numpy(t):
    return tree.tree_map(lambda a: a.detach().numpy(), t)


def ep_case(mesh, layer_np, x, g, mode: str, device="cpu") -> dict:
    """One rank's expert-parallel ``moe_apply`` of the global tokens ``x``
    (B, S, d) under ``mode``: this rank's rows of y, aux, and the grads of
    its loss ``sum(y * g) + aux / data`` (the ranks' losses sum to the
    one-device ``sum(y * g) + aux``) for its rows of x and its blocks of
    the layer's params."""
    cfg = ep_cfg(mode)
    n_data = mesh.plan.data
    rows = x.shape[0] // n_data
    x_loc = torch.from_numpy(x[mesh.data_index * rows:
                               (mesh.data_index + 1) * rows]).to(device)
    x_loc.requires_grad_()
    g_loc = torch.from_numpy(g[mesh.data_index * rows:
                               (mesh.data_index + 1) * rows]).to(device)
    layout = moe.ep_layout(cfg, mesh, x_loc.shape[0] * x_loc.shape[1])
    specs = moe.expert_placements(layer_np, layout)
    full = _tensors(layer_np)
    local = tree.map_with_path(lambda path, a: sharding.shard_of(
        a, tree.at(specs, path), mesh, mesh.coords).to(device)
        .requires_grad_(), full)
    y, aux = moe.moe_apply(local, cfg, x_loc, mesh=mesh)
    ((y * g_loc).sum() + aux / n_data).backward()
    return {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
            "two_d": layout.two_d, "ep": layout.ep,
            "x_grad": x_loc.grad.cpu().numpy(),
            "grads": _numpy(tree.tree_map(lambda a: a.grad.cpu(), local)),
            "specs": specs}


def sp_scan_case(a, b, h0, device="cpu") -> dict:
    """This rank's block of ``scan_sequence_parallel`` over the whole
    world, the time axis (-2) split in rank order, and the grad of
    ``sum(h)`` for its block of ``a``, ``b`` and (whole) ``h0``."""
    import torch.distributed as dist
    n, r = dist.get_world_size(), dist.get_rank()
    t = a.shape[-2] // n
    sl = slice(r * t, (r + 1) * t)
    at, bt, h0t = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   .requires_grad_()
                   for v in (a[..., sl, :], b[..., sl, :], h0))
    h = scan_lib.scan_sequence_parallel(at, bt, dist.group.WORLD, h0=h0t)
    h.sum().backward()
    return {"h": h.detach().cpu().numpy(), "a_grad": at.grad.cpu().numpy(),
            "b_grad": bt.grad.cpu().numpy(),
            "h0_grad": h0t.grad.cpu().numpy()}


def dp_case(mesh, params_np, batches, grad_dtype) -> dict:
    """``len(batches)`` steps of ``make_dp_compressed_step`` from the
    given params: the losses, the final params and whether every
    replica's bits agree with data rank 0's."""
    cfg = archs.smoke("mingru-lm")
    params = _tensors(params_np)
    state = opt_lib.init(DP_OPT, params)
    step = ts_lib.make_dp_compressed_step(cfg, DP_OPT, mesh,
                                          grad_dtype=grad_dtype)
    losses = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _numpy(params),
            "replicas_equal": _replicas_equal(params)}


def _replicas_equal(params) -> bool:
    """Every rank holds the same bits of every leaf as rank 0."""
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1).float() for p in
                      tree.leaves(params)])
    first = flat.clone()
    dist.broadcast(first, src=0)
    return bool(torch.equal(first, flat))


def world_2(params_np, layer_np, x, g, batches) -> dict:
    """A 2-rank world: the DP step at 2x1 (fp32 and bf16 grads) and EP
    at 1x2."""
    out = {}
    dp = serve_mesh.MeshPlan(2, 1).build()
    out["dp_bf16"] = dp_case(dp, params_np, batches, torch.bfloat16)
    out["dp_fp32"] = dp_case(dp, params_np, batches, torch.float32)
    out["ep_1x2"] = ep_case(serve_mesh.MeshPlan(1, 2).build(), layer_np, x,
                            g, "auto")
    return out


MOE_OPT = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")


def moe_lm_cfg(mode: str):
    cfg = archs.smoke("deepseek-moe-16b")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, ep_2d=mode))


def mesh_step_case(mesh, params_np, batch, mode: str) -> dict:
    """One ``make_mesh_train_step`` of the smoke deepseek-moe-16b with its
    experts split as ``ep_2d=mode`` places them: the loss, the global
    grad norm, this rank's blocks of the grads (``mesh_value_and_grad``)
    and of the updated params, and their placements."""
    cfg = moe_lm_cfg(mode)
    tokens = batch["tokens"].shape[0] // mesh.plan.data \
        * batch["tokens"].shape[1]
    layout = moe.ep_layout(cfg, mesh, tokens)
    specs = moe.expert_placements(params_np, layout)
    params = tree.map_with_path(lambda path, a: sharding.shard_of(
        torch.from_numpy(np.array(a)), tree.at(specs, path), mesh,
        mesh.coords), params_np)
    _, grads, _ = ts_lib.mesh_value_and_grad(cfg, mesh, specs, params, batch)
    step = ts_lib.make_mesh_train_step(cfg, MOE_OPT, mesh, specs)
    params, _, m = step(params, opt_lib.init(MOE_OPT, params), batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": _numpy(grads), "params": _numpy(params),
            "specs": specs, "two_d": layout.two_d}


def world_4(layer_np, x, g, scan_in, lm_np=None, lm_batch=None) -> dict:
    """A 4-rank world: EP at 2x2 with ``ep_2d`` off and on (the layer,
    and with ``lm_np`` one ``make_mesh_train_step`` of the smoke
    deepseek-moe-16b on ``lm_batch``), and the sequence-parallel scan
    over the 4 ranks."""
    mesh = serve_mesh.MeshPlan(2, 2).build()
    out = {f"ep_{mode}": ep_case(mesh, layer_np, x, g, mode)
           for mode in ("off", "on")}
    if lm_np is not None:
        for mode in ("off", "on"):
            out[f"step_{mode}"] = mesh_step_case(mesh, lm_np, lm_batch, mode)
    out["sp_scan"] = sp_scan_case(*scan_in)
    return out


def world_8(ckpt_path: str) -> dict:
    """An 8-rank world (4x2): a whole checkpoint restored as this rank's
    blocks under ``params_pspecs``, the blocks, their placements, and
    the leaves reassembled by ``join_blocks``."""
    mesh = serve_mesh.MeshPlan(4, 2).build()
    _, whole, _ = ckpt_lib.restore(ckpt_path, device="cpu")
    specs = sharding.params_pspecs(whole, mesh)
    step, blocks, opt = ckpt_lib.restore(ckpt_path, device="cpu",
                                         placements=specs, mesh=mesh)
    joined = tree.map_with_path(
        lambda path, b: sharding.join_blocks(b, tree.at(specs, path), mesh),
        blocks)
    return {"step": step, "coords": mesh.coords, "specs": specs,
            "blocks": _numpy(blocks), "joined": _numpy(joined),
            "mu_blocks": _numpy(opt.mu) if opt is not None else None}


def card_dp(mesh, dtype: str, batches) -> dict:
    """On the card: the smoke minGRU LM in ``dtype``, weights drawn there
    from seed 0, ``make_dp_compressed_step`` over ``batches``: losses,
    fused-cell and reversed-scan launches a step, final params (fp32
    numpy) and the replicas' bits against rank 0's."""
    from repro_torch.kernels.fused_mingru import ops as gru_ops
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.models import lm
    dev = serve_mesh.rank_device("cuda")
    cfg = archs.smoke("mingru-lm").replace(param_dtype=dtype,
                                           compute_dtype=dtype)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    state = opt_lib.init(DP_OPT, params)
    step = ts_lib.make_dp_compressed_step(cfg, DP_OPT, mesh)
    losses, per_step = [], []
    for batch in batches:
        gru_ops.reset_launches()
        scan_ops.reset_launches()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        per_step.append((gru_ops.LAUNCHES["fused_mingru_kernel"],
                         scan_ops.LAUNCHES["linear_scan_kernel"]))
    return {"losses": losses, "per_step": per_step,
            "params": tree.tree_map(lambda a: a.detach().float().cpu()
                                    .numpy(), params),
            "replicas_equal": _replicas_equal(params), "device": str(dev)}


def card_world(layer_np, x, g, scan_in, batches) -> dict:
    """A 4-rank world on the card (every rank on cuda:0): the DP step at
    2x2 in bf16, EP at 2x2 with ``ep_2d`` off and on in fp32, and the
    sequence-parallel scan over the 4 ranks."""
    dev = serve_mesh.rank_device("cuda")
    mesh = serve_mesh.MeshPlan(2, 2).build()
    out = {"dp": card_dp(mesh, "bfloat16", batches)}
    for mode in ("off", "on"):
        out[f"ep_{mode}"] = ep_case(mesh, layer_np, x, g, mode, dev)
    out["sp_scan"] = sp_scan_case(*scan_in, device=dev)
    return out
