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

The reference computes all of this in ``jnp`` outside any Pallas kernel;
so does the port, in PyTorch ops.  Expert parallelism over a mesh (and
its 2D form, ``ep_2d``) is not ported: ``mesh=`` raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import nn
from repro_torch.models import mlp as mlp_lib

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
    not fit the card beside the layers already drawn."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    std = math.sqrt(1.0 / d_in)
    for i in range(e):
        t = torch.empty((d_in, d_out), dtype=torch.float32,
                        device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[i] = (std * t).to(dtype)
    return {"kernel": out}


def _moe_body(router_w, gate_w, up_w, down_w, x: torch.Tensor, *, cfg,
              activation: str, rows: Optional[int] = None,
              with_aux: bool = True):
    """x: (N, d) tokens -> (y (N, d), aux): the reference's ``_moe_body``
    with one expert group (``n_local = E``, ``e_offset = 0``); aux None
    without ``with_aux``."""
    m = cfg.moe
    n, d = x.shape
    k, n_exp = m.top_k, m.n_experts
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
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)          # renormalise
    topk_p = topk_p.to(x.dtype)

    # auxiliary load-balance loss
    onehot = F.one_hot(topk_i, n_exp)                           # (N, k, E)
    aux = None
    if with_aux:
        f_e = onehot.sum(dim=1).float().mean(dim=0)
        p_e = probs.mean(dim=0)
        aux = n_exp * torch.sum(f_e * p_e) / k

    # dispatch: each assignment's position inside its expert, counted
    # over the token-major flattened (N*k, E) one-hot (the running count
    # scanned along the inner axis of its transpose: integers, the same
    # counts, without a scan over the outer axis of N*k rows)
    flat = onehot.reshape(n * k, n_exp)
    count = flat.t().cumsum(dim=1).t()
    pos = ((count * flat).sum(dim=-1) - 1).reshape(n, k)
    keep = pos < cap
    if _HOOKS["drops"] is not None:
        _HOOKS["drops"].append(((~keep).sum(), n * k))
    junk = n_exp * cap                                          # one row
    dest = torch.where(keep, topk_i * cap + pos, junk)          # (N, k)
    buf = x.new_zeros((junk + 1, d))
    buf.index_put_((dest.reshape(-1),), torch.where(
        keep[..., None], x[:, None, :], 0).reshape(n * k, d))
    buf = buf[:junk].reshape(n_exp, cap, d)

    # the experts, batched over the expert axis
    act = nn.ACTIVATIONS[activation]
    gw, uw, dw = (w.to(x.dtype) for w in (gate_w, up_w, down_w))

    def experts(b):
        return torch.bmm(act(torch.bmm(b, gw)) * torch.bmm(b, uw), dw)

    out = nn.tiled(experts, buf, rows, dim=1).reshape(n_exp * cap, d)

    # combine: each token's kept slots weighted and summed in slot order
    src = torch.where(keep, dest, 0).reshape(-1)
    parts = torch.where(keep[..., None], out[src].reshape(n, k, d)
                        * topk_p[..., None], 0)
    y = x.new_zeros((n, d))
    for slot in range(k):
        y = y + parts[:, slot]
    return y, aux


def moe_apply(params, cfg, x: torch.Tensor, *, activation: str = "silu",
              rows: Optional[int] = None, with_aux: bool = True, mesh=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (y, aux loss): the routed experts over all B * S
    tokens, plus the shared experts.  ``rows``: run every product in
    tiles of that many rows (the decode step); ``with_aux`` False skips
    the aux loss (None), which a decode step drops."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (and 2D expert parallelism, "
            "ep_2d) is not ported (ROADMAP.md queue 1, item 6)")
    m = cfg.moe
    bsz, s, d = x.shape
    tokens = x.reshape(bsz * s, d)
    y, aux = _moe_body(params["router"]["kernel"],
                       params["gate_w"]["kernel"], params["up_w"]["kernel"],
                       params["down_w"]["kernel"], tokens, cfg=cfg,
                       activation=activation, rows=rows, with_aux=with_aux)
    if m.n_shared:
        y = y + nn.tiled(lambda t: mlp_lib.mlp_apply(
            params["shared"], t, activation=activation,
            compute_dtype=cfg.cdtype), tokens, rows)
    return y.reshape(bsz, s, d), aux
