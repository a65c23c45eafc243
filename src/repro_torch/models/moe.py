"""Mixture-of-Experts layer (``repro.models.moe``): deepseek-moe-16b's
routed experts with a capacity, plus shared experts.

The reference's no-mesh path: every token is routed over all E experts
(fp32 router softmax, top-k, renormalised), each assignment takes the
next free position in its expert's buffer of ``capacity`` rows -- the
position counted over the token-major flattened (N*k, E) one-hot -- and
an assignment past the capacity is dropped into a junk row.  The experts
run as batched products over the (E, capacity, d) buffer, and the
combine sums each token's kept slots in slot order.  The router's
auxiliary load-balance loss is ``E * sum_e f_e * p_e / k``.

Dispatch is deterministic: one plain indexed store writes every kept
(expert, position) pair, and those are unique; the dropped assignments
all write zeros to the junk row.  Nothing is accumulated atomically.

``rows`` (the decode step's ``attention.DECODE_ROWS``) runs every product
of the layer -- the router, the experts over the capacity axis, the
shared experts -- in tiles of that many rows, the last tile padded with
zero rows: cuBLAS picks a product's kernel, and so a sum's order, by its
row count, and the capacity grows with the number of tokens, so a
token's result would otherwise depend on how many rows came with it.

**Expert parallelism** (a data x model mesh, ``serve_mesh.RankMesh``:
one process per position).  Tokens are split over the data ranks and
whole on every model rank; each model rank routes every local token,
keeps only its ``E / model`` experts (those at ``e_offset = model_index
* n_local``), sends every other assignment to the junk row, and counts
positions over the (N*k, n_local+1) one-hot, so its buffer equals the
matching rows of the one-device buffer.  One all-reduce over the model
group combines the ranks' contributions; the aux statistics ``f_e`` and
``p_e`` are averaged over the data group before ``aux`` is formed.
**2D** (``ep_2d``): the expert weights are also split over the data ranks
along d (:func:`expert_placements`); the dispatched rows are transposed
across the data group (an all-to-all: every data rank then holds every
rank's rows and its own d slice), the gate and up partials summed over
it, and the down product's rows sent back.  EP is off under
``pure_dp()`` or when ``model`` does not divide E; a rank then routes its
own tokens as one device does.

The collectives carry Megatron's conjugate pair for autograd
(``distributed/collectives.py``): the tokens and the router's
probabilities enter a model rank's dispatch through ``copy_to`` (each
rank's gradient there covers its own experts: the backward sums them
over the model group), and the combine leaves through ``reduce_from``.
The data-group means of ``f_e`` / ``p_e`` pass their gradient unchanged,
and the 2D hidden activation enters the down product through
``copy_to`` over the data group.  So a rank's gradients are those of the
sum of the ranks' losses: a leaf whole on the data ranks sums its
gradients over them, a block split over them (2D) has its own whole.

The reference computes all of this in ``jnp`` outside any Pallas kernel;
so does the port, in PyTorch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import nn
from repro_torch.device import fake_mode
from repro_torch.distributed import collectives
from repro_torch.distributed import context as mesh_ctx
from repro_torch.models import mlp as mlp_lib
from repro_torch.tree import map_with_path

# what the MoE calls inside ``count_drops`` / ``routing_log`` /
# ``forced_routing`` report or take; None outside them
_HOOKS: Dict[str, Any] = {"drops": None, "log": None, "force": None}


@contextlib.contextmanager
def _hook(name, value):
    prev, _HOOKS[name] = _HOOKS[name], value
    try:
        yield value
    finally:
        _HOOKS[name] = prev


def count_drops():
    """Collect each MoE call's dropped and total top-k assignments while
    the block runs; yields the list of (dropped count tensor, assigned)
    pairs, one per call, read after the block."""
    return _hook("drops", [])


def routing_log():
    """Collect each MoE call's own top-k expert indices, (N, k), in call
    order, while the block runs (under ``forced_routing`` too: the
    choices the call would have made); yields the list."""
    return _hook("log", [])


def forced_routing(experts):
    """Within the block, the i-th MoE call routes its tokens to the
    experts ``experts(i)`` gives, (N, k), in place of its own top-k; the
    gates are its own probabilities at those experts, renormalised.  Two
    routes of one prompt -- a prefill and its sequential steps -- held to
    one routing differ by their rounding alone: in bf16 a rounding apart
    flips a near-tied top-k choice, and the flip then changes the token's
    expert mix."""
    return _hook("force", [experts, 0])


def moe_init(gen: torch.Generator, cfg, *, dtype=torch.float32):
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": nn.dense_init(gen, d, m.n_experts, use_bias=False,
                                dtype=torch.float32),   # router kept fp32
        "gate_w": _expert_init(gen, m.n_experts, d, m.d_expert, dtype),
        "up_w": _expert_init(gen, m.n_experts, d, m.d_expert, dtype),
        "down_w": _expert_init(gen, m.n_experts, m.d_expert, d, dtype),
    }
    if m.n_shared:
        p["shared"] = mlp_lib.mlp_init(gen, d, m.d_shared, gated=True,
                                       dtype=dtype)
    return p


def _expert_init(gen, e, d_in, d_out, dtype):
    """(e, d_in, d_out) LeCun-normal weights, drawn an expert at a time:
    the fp32 draw of a whole deepseek-v3-671b expert weight (15 GB) would
    not fit the card beside the layers already drawn.  A fake trace
    takes the shape alone (``launch/input_specs.py``)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    if fake_mode() is not None:
        return {"kernel": out}
    std = math.sqrt(1.0 / d_in)
    for i in range(e):
        t = torch.empty((d_in, d_out), dtype=torch.float32,
                        device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[i] = (std * t).to(dtype)
    return {"kernel": out}


@dataclasses.dataclass(frozen=True)
class EPLayout:
    """Where one MoE call runs: on one device (``ep`` False), or expert
    parallel over the mesh, with the expert weights also split over the
    data ranks along d when ``two_d``."""
    ep: bool
    two_d: bool = False


def ep_layout(cfg, mesh, n_tokens: int) -> EPLayout:
    """The reference's choice for a call of ``n_tokens`` tokens on each
    data rank: EP when the mesh's ``model`` axis is > 1, divides E and
    ``pure_dp()`` is off; 2D when ``ep_2d`` is "on", or "auto" and
    ``cap_est * 4 < d_expert`` (the dispatched rows' all-to-all is
    cheaper than gathering the weights: decode, and training at a few
    thousand tokens a rank), and the data axis is > 1 and divides d."""
    m = cfg.moe
    ep = mesh_ctx.axis_size(mesh, "model")
    if not (ep > 1 and m.n_experts % ep == 0 and not mesh_ctx.pure_dp()):
        return EPLayout(False)
    cap_est = max(1, int(m.capacity_factor * max(1, n_tokens) * m.top_k
                         / m.n_experts))
    want = {"on": True, "off": False}.get(m.ep_2d, cap_est * 4 < m.d_expert)
    d_size = mesh_ctx.axis_size(mesh, "data")
    return EPLayout(True, want and d_size > 1 and cfg.d_model % d_size == 0)


def expert_placements(params, layout: EPLayout):
    """The placements of ``params`` (an LM's tree, or one MoE layer's)
    under ``layout``: the routed experts' kernels (E, d_in, d_out), after
    any stacked-layer dims, over ``model`` on E, and in 2D over ``data``
    on d; every other leaf (the router, the shared experts, the rest of
    the model) whole on every rank."""
    ex = "model" if layout.ep else None
    dd = "data" if layout.two_d else None
    rule = {"gate_w": (ex, dd, None), "up_w": (ex, dd, None),
            "down_w": (ex, None, dd)}

    def spec(path, leaf):
        nd = len(leaf.shape)
        lead = (None,) * (nd - 3)
        if len(path) >= 2 and path[-1] == "kernel" and path[-2] in rule:
            return lead + rule[path[-2]]
        return (None,) * nd

    return map_with_path(spec, params)


def _moe_body(router_w, gate_w, up_w, down_w, x: torch.Tensor, *, cfg,
              activation: str, rows: Optional[int] = None,
              with_aux: bool = True, n_local: Optional[int] = None,
              e_offset: int = 0, model_group=None, data_group=None,
              fsdp_group=None):
    """x: (N, d) local tokens -> (y (N, d), aux): the reference's
    ``_moe_body``; aux None without ``with_aux``.  ``n_local`` experts
    from ``e_offset`` are this rank's (all E by default); the expert
    weights are this rank's blocks.  ``model_group``: the group whose
    ranks hold the other experts (the combine's all-reduce);
    ``data_group``: the group the aux statistics are averaged over;
    ``fsdp_group``: the 2D transposes' group (the expert weights split
    along d over it)."""
    m = cfg.moe
    n, d = x.shape
    k, n_exp = m.top_k, m.n_experts
    n_local = n_exp if n_local is None else n_local
    cap = max(1, int(m.capacity_factor * n * k / n_exp))       # rows each

    logits = nn.tiled(lambda t: t.float() @ router_w.float(), x, rows)
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    topk_p, topk_i = torch.topk(probs, k, dim=-1)               # sorted
    if _HOOKS["log"] is not None:
        _HOOKS["log"].append(topk_i)
    if _HOOKS["force"] is not None:
        force = _HOOKS["force"]
        topk_i = force[0](force[1]).to(topk_i.device)
        topk_p = probs.gather(-1, topk_i)
        force[1] += 1
    if model_group is not None:
        # the gates enter this rank's part of the combine: their gradient
        # is summed over the model ranks
        topk_p = collectives.copy_to(probs, model_group).gather(-1, topk_i)
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)          # renormalise
    topk_p = topk_p.to(x.dtype)

    # auxiliary load-balance loss, over the whole router; the statistics
    # averaged over the data ranks first, so it equals the one-device
    # value on the global batch
    onehot = F.one_hot(topk_i, n_exp)                           # (N, k, E)
    aux = None
    if with_aux:
        f_e = onehot.sum(dim=1).float().mean(dim=0)
        p_e = probs.mean(dim=0)
        if data_group is not None:
            f_e = collectives.reduce_from(f_e, data_group, mean=True)
            p_e = collectives.reduce_from(p_e, data_group, mean=True)
        aux = n_exp * torch.sum(f_e * p_e) / k

    # dispatch: each assignment's position inside its expert, counted
    # over the token-major flattened (N*k, n_local + 1) one-hot, the last
    # column the other ranks' experts (the running count scanned along
    # the inner axis of its transpose: integers, the same counts, without
    # a scan over the outer axis of N*k rows)
    if n_local == n_exp:
        is_local, local_i, flat = None, topk_i, onehot.reshape(n * k, n_exp)
    else:
        local_i = topk_i - e_offset
        is_local = (local_i >= 0) & (local_i < n_local)
        local_i = torch.where(is_local, local_i, n_local)
        flat = F.one_hot(local_i, n_local + 1).reshape(n * k, n_local + 1)
    count = flat.t().cumsum(dim=1).t()
    pos = ((count * flat).sum(dim=-1) - 1).reshape(n, k)
    keep = pos < cap
    if is_local is not None:
        keep = keep & is_local
    if _HOOKS["drops"] is not None:
        # this rank's experts' drops (is_local: of its own assignments)
        dropped = (~keep).sum() if is_local is None \
            else (is_local & ~keep).sum()
        _HOOKS["drops"].append((dropped, n * k))
    junk = n_local * cap                                        # one row
    dest = torch.where(keep, local_i * cap + pos, junk)         # (N, k)
    xs = x if model_group is None else collectives.copy_to(x, model_group)
    buf = xs.new_zeros((junk + 1, d))
    buf.index_put_((dest.reshape(-1),), torch.where(
        keep[..., None], xs[:, None, :], 0).reshape(n * k, d))
    buf = buf[:junk].reshape(n_local, cap, d)

    # the experts, batched over the expert axis
    act = nn.ACTIVATIONS[activation]
    gw, uw, dw = (w.to(x.dtype) for w in (gate_w, up_w, down_w))

    if fsdp_group is None:
        def experts(b):
            return torch.bmm(act(torch.bmm(b, gw)) * torch.bmm(b, uw), dw)

        out = nn.tiled(experts, buf, rows, dim=1).reshape(n_local * cap, d)
    else:
        # 2D: every data rank takes all the data ranks' rows and its own d
        # slice, (E_l, cap * D, d / D); the gate and up partials summed over
        # the data ranks; the down product's rows sent back
        buf2 = collectives.all_to_all(buf, fsdp_group, 2, 1)
        gate_h = collectives.reduce_from(
            nn.tiled(lambda b: torch.bmm(b, gw), buf2, rows, dim=1),
            fsdp_group)
        up_h = collectives.reduce_from(
            nn.tiled(lambda b: torch.bmm(b, uw), buf2, rows, dim=1),
            fsdp_group)
        h = collectives.copy_to(act(gate_h) * up_h, fsdp_group)
        out_slice = nn.tiled(lambda t: torch.bmm(t, dw), h, rows, dim=1)
        out = collectives.all_to_all(out_slice, fsdp_group, 1, 2).reshape(
            n_local * cap, d)

    # combine: each token's kept slots weighted and summed in slot order
    src = torch.where(keep, dest, 0).reshape(-1)
    parts = torch.where(keep[..., None], out[src].reshape(n, k, d)
                        * topk_p[..., None], 0)
    y = x.new_zeros((n, d))
    for slot in range(k):
        y = y + parts[:, slot]
    if model_group is not None:
        y = collectives.reduce_from(y, model_group)
    return y, aux


def moe_apply(params, cfg, x: torch.Tensor, *, activation: str = "silu",
              rows: Optional[int] = None, with_aux: bool = True, mesh=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (y, aux loss): the routed experts over all B * S
    tokens, plus the shared experts.  ``rows``: run every product in
    tiles of that many rows (the decode step); ``with_aux`` False skips
    the aux loss (None), which a decode step drops.

    ``mesh`` (default: ``context.current_mesh()``), a data x model
    ``RankMesh``: ``x`` is this rank's block of the batch and, under
    expert parallelism (:func:`ep_layout`), the expert weights are this
    rank's blocks (:func:`expert_placements`)."""
    m = cfg.moe
    bsz, s, d = x.shape
    tokens = x.reshape(bsz * s, d)
    mesh = mesh_ctx.current_mesh() if mesh is None else mesh
    layout = ep_layout(cfg, mesh, bsz * s)
    w = (params["router"]["kernel"], params["gate_w"]["kernel"],
         params["up_w"]["kernel"], params["down_w"]["kernel"])
    if not layout.ep:
        y, aux = _moe_body(*w, tokens, cfg=cfg, activation=activation,
                           rows=rows, with_aux=with_aux)
    else:
        n_local = m.n_experts // mesh.shape["model"]
        d_loc = d // mesh.shape["data"] if layout.two_d else d
        want = {"gate_w": (n_local, d_loc, m.d_expert),
                "up_w": (n_local, d_loc, m.d_expert),
                "down_w": (n_local, m.d_expert, d_loc)}
        for key, shape in want.items():
            got = tuple(params[key]["kernel"].shape)
            if got != shape:
                raise ValueError(
                    f"moe_apply on a {mesh.shape} mesh "
                    f"({'2D' if layout.two_d else '1D'} expert parallelism): "
                    f"{key} must be this rank's block {shape}, got {got} "
                    f"(moe.expert_placements)")
        y, aux = _moe_body(
            *w, tokens, cfg=cfg, activation=activation, rows=rows,
            with_aux=with_aux, n_local=n_local,
            e_offset=mesh.model_index * n_local,
            model_group=mesh.model_group, data_group=mesh.data_group,
            fsdp_group=mesh.data_group if layout.two_d else None)
    if m.n_shared:
        y = y + nn.tiled(lambda t: mlp_lib.mlp_apply(
            params["shared"], t, activation=activation,
            compute_dtype=cfg.cdtype), tokens, rows)
    return y.reshape(bsz, s, d), aux
