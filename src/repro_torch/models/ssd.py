"""Mamba2 / SSD (state-space duality) sequence mixer (``repro.models.ssd``).

The SSD recurrence is the matrix-valued generalisation of the paper's
minGRU recurrence:

    H_t = a_t * H_{t-1} + dt_t * B_t (x) x_t        H: (heads, hd, d_state)
    y_t = C_t . H_t + D * x_t

with a scalar decay per head, a_t = exp(-exp(a_log) * dt_t).  Training and
prefill use the chunked dual form (Dao & Gu 2024): inside a chunk the
attention-like products (C B^T ⊙ decay mask) @ X, across chunks the
paper's linear scan over the chunk states (``core.scan.scan_associative``).
Decode steps the recurrence (``ssd_step``).

The reference runs no Pallas kernel here, and neither does the port: these
are PyTorch ops.  The dtypes follow the reference's promotions (a bf16
operand meeting an fp32 one computes in fp32), with three departures in a
bf16 config, so that the prefill and the decode step take the same
roundings (they parted by 8% of the largest logit after 48 layers
otherwise; in an fp32 config nothing changes):

  * the causal conv sums its K products in fp32 and rounds once, in both
    routes (the reference rounds every product and partial sum of the
    parallel form, but only the step's einsum result);
  * the masked form's C B^T and decay mask stay fp32 (the reference
    rounds both to bf16);
  * the decode read-out C . H runs in fp32 and y stays fp32 up to the
    out-projection, as the chunked form's does (the reference rounds the
    state and y to bf16).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import nn
from repro_torch.core import scan as scan_lib
from repro_torch.device import resolve_device


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` after promoting every operand to their common
    dtype, as ``jnp.einsum`` does with mixed operands."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _heads(v: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Groups broadcast to heads (``jnp.repeat`` along ``dim``)."""
    return v.repeat_interleave(rep, dim=dim) if rep > 1 else v


def ssd_init(gen: torch.Generator, cfg, *, dtype=torch.float32):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    dev = gen.device
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * torch.rand((nh,), generator=gen, device=dev)
    return {
        "in_proj": nn.dense_init(gen, d, proj_out, use_bias=False,
                                 dtype=dtype),
        "conv": nn.causal_conv_init(
            gen, d_in + 2 * s.n_groups * s.d_state, s.conv_kernel, dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).float(),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "out_norm": nn.rmsnorm_init(d_in, dtype),
        "out_proj": nn.dense_init(gen, d_in, d, use_bias=False, dtype=dtype),
    }


def _conv(p, x: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over (B, T, D), zeros before T 0: the K
    products summed in fp32, rounded once to x's dtype."""
    k = p["kernel"].float()
    ksize, t = k.shape[0], x.shape[-2]
    xp = torch.cat([x.new_zeros(x.shape[:-2] + (ksize - 1, x.shape[-1])),
                    x], dim=-2).float()
    y = xp[..., 0:t, :] * k[0]
    for i in range(1, ksize):
        y = y + xp[..., i:i + t, :] * k[i]
    return (y + p["bias"].float()).to(x.dtype)


def _conv_step(p, x_t: torch.Tensor, conv_state: torch.Tensor):
    """One step of ``_conv``: conv_state (B, K-1, D) the trailing inputs
    -> (y_t, the new window); the K products summed in fp32 (in the
    einsum's order, which may differ from ``_conv``'s in the last fp32
    bit), rounded once."""
    window = torch.cat([conv_state, x_t[..., None, :]], dim=-2)
    y = torch.einsum("...kd,kd->...d", window.float(), p["kernel"].float())
    return (y + p["bias"].float()).to(x_t.dtype), window[..., 1:, :]


def _split_proj(cfg, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    gs = s.n_groups * s.d_state
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in],
            zxbcdt[..., 2 * d_in:2 * d_in + gs],
            zxbcdt[..., 2 * d_in + gs:2 * d_in + 2 * gs],
            zxbcdt[..., 2 * d_in + 2 * gs:])


def _pad_time(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the last position of dim 1."""
    return torch.cat([v, v.new_zeros((v.shape[0], pad) + tuple(v.shape[2:]))],
                     dim=1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, return_state: bool = False,
                form: str = "masked"):
    """Chunked SSD.

    x: (B, T, H, P) heads x head_dim; dt: (B, T, H) softplus-ed step
    sizes; b, c: (B, T, G, N), groups broadcast over heads.  Returns y
    (B, T, H, P) [, the state after the last position (B, H, P, N)].

    ``form``: "masked" (the published form: the (B, nc, L, L, H) fp32
    decay mask) or "compact" (the same products with the mask folded into
    C B^T before the head broadcast and every (L, L, H)-sized op in the
    compute dtype)."""
    if form not in ("masked", "compact"):
        raise ValueError(f"unknown SSD dual form {form!r}")
    bsz, t, h, p = x.shape
    g, n = b.shape[-2], b.shape[-1]
    rep = h // g
    pad = (-t) % chunk
    if pad:             # inert steps: dt 0 (decay 1), update 0
        x, dt, b, c = (_pad_time(v, pad) for v in (x, dt, b, c))
    tt = x.shape[1]
    nc = tt // chunk

    # log decay per step: log a_t = -exp(a_log) * dt
    log_a = (-torch.exp(a_log)[None, None, :] * dt).float()

    def ch(v):          # (B, T, ...) -> (B, nc, L, ...)
        return v.reshape((bsz, nc, chunk) + tuple(v.shape[2:]))

    xc, dtc, bc, cc = ch(x), ch(dt), ch(b), ch(c)
    cum = torch.cumsum(ch(log_a), dim=2)              # within-chunk cumsum
    total = cum[:, :, -1]                             # (B, nc, H)
    xdt = xc * dtc[..., None]                         # (B, nc, L, H, P)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]

    if form == "masked":
        # M[i, j] = exp(cum[i] - cum[j]) for i >= j (segment decay).  The
        # double where: exp(seg > 0) on the masked triangle overflows, and
        # its inf cotangent x 0 would poison the gradient with NaNs
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        m = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
        # C B^T and the mask in fp32 (xdt's dtype), unrounded
        cb = _heads(_einsum("bclgn,bcsgn->bclsg", cc, bc.to(xdt.dtype)),
                    rep, -1)
        y_intra = torch.einsum("bclsh,bcshp->bclhp", cb * m, xdt)
    else:
        cdt = x.dtype
        cum_c = cum.to(cdt)
        cb = torch.einsum("bclgn,bcsgn->bclsg", cc, bc)
        cb = torch.where(causal, cb, 0.0)             # mask pre-repeat
        seg = cum_c[:, :, :, None, :] - cum_c[:, :, None, :, :]
        # true decays are <= 0; the upper triangle (seg > 0) is masked by
        # cb = 0 already, so clamp it rather than let it overflow
        w = torch.exp(torch.clamp(seg, max=0)) * _heads(cb, rep, -1)
        y_intra = torch.einsum("bclsh,bcshp->bclhp", w, xdt.to(cdt))

    # chunk states
    decay_to_end = torch.exp(total[:, :, None, :] - cum)     # (B,nc,L,H)
    v = xdt * decay_to_end[..., None]
    if form == "compact":
        # contracted in group space: no head-repeated b
        v_g = v.reshape(bsz, nc, chunk, g, rep, p)
        states = _einsum("bcsgn,bcsgrp->bcgrpn", bc, v_g).reshape(
            bsz, nc, h, p, n)
    else:
        states = _einsum("bcshn,bcshp->bchpn", _heads(bc, rep, -2), v)

    # inter-chunk: the paper's linear scan over the chunk states
    a_chunk = torch.exp(total)                               # (B, nc, H)
    flat = states.reshape(bsz, nc, h * p * n)
    a_bc = a_chunk.repeat_interleave(p * n, dim=-1)
    carried = scan_lib.scan_associative(a_bc, flat, axis=-2).reshape(
        bsz, nc, h, p, n)
    final_state = carried[:, -1]                             # (B, H, P, N)
    prev = torch.cat([torch.zeros_like(carried[:, :1]), carried[:, :-1]],
                     dim=1)

    # inter-chunk contribution
    if form == "compact":
        y_inter = _einsum("bclgn,bcgrpn->bclgrp", cc,
                          prev.reshape(bsz, nc, g, rep, p, n)).reshape(
            bsz, nc, chunk, h, p)
        y_inter = y_inter * torch.exp(cum)[..., None].to(y_inter.dtype)
    else:
        y_inter = _einsum("bclhn,bchpn->bclhp", _heads(cc, rep, -2),
                          prev) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, tt, h, p)[:, :t]
    y = y + x[:, :t] * d_skip[None, None, :, None].to(x.dtype)
    if return_state:
        # the padding is inert, so the last chunk's state is exactly the
        # state after position t - 1
        return y, final_state
    return y


def ssd_sequential(x, dt, a_log, b, c, d_skip,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential reference (oracle and decode roll-out); shapes as
    ``ssd_chunked``."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=x.device) if h0 is None else h0
    ys = []
    for i in range(t):
        y_t, state = ssd_step(x[:, i], dt[:, i], a_log, b[:, i], c[:, i],
                              d_skip, state)
        ys.append(y_t)
    return torch.stack(ys, dim=1)


def ssd_step(x_t, dt_t, a_log, b_t, c_t, d_skip, state):
    """One decode step.  x_t: (B, H, P); dt_t: (B, H); b_t, c_t: (B, G, N);
    state: (B, H, P, N) fp32 -> (y_t (B, H, P) in the state's dtype, new
    state)."""
    h = x_t.shape[-2]
    rep = h // b_t.shape[-2]
    a_t = torch.exp(-torch.exp(a_log) * dt_t)                # (B, H)
    b_heads = b_t.repeat_interleave(rep, dim=-2)             # (B, H, N)
    c_heads = c_t.repeat_interleave(rep, dim=-2)
    upd = (dt_t[..., None] * x_t)[..., None] * b_heads[..., None, :]
    state = a_t[..., None, None] * state + upd.to(state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", state, c_heads.to(state.dtype))
    return y + x_t * d_skip[None, :, None].to(x_t.dtype), state


# ---------------------------------------------------------------------------
# The full mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _conv_split(cfg, xbc):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    gs = s.n_groups * s.d_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + gs], xbc[..., d_in + gs:]


def ssd_inputs(params, cfg, u: torch.Tensor,
               lengths: Optional[torch.Tensor] = None):
    """The block up to its SSD: u (B, T, d_model) -> {"z" (B, T, d_inner),
    "xbc" (the conv's input, for the decode window), and ``ssd_chunked``'s
    "x" (B, T, H, P), "dt" (B, T, H) fp32, "b", "c" (B, T, G, N)}.
    ``lengths``: padded positions get dt 0 and x 0 (inert steps)."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    z, x, b, c, dt = _split_proj(cfg, nn.dense_apply(params["in_proj"], u,
                                                     cfg.cdtype))
    xbc = torch.cat([x, b, c], dim=-1)
    x, b, c = _conv_split(cfg, F.silu(_conv(params["conv"], xbc)))
    bsz, t, _ = x.shape
    x = x.reshape(bsz, t, nh, s.head_dim)
    b = b.reshape(bsz, t, s.n_groups, s.d_state)
    c = c.reshape(bsz, t, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    if lengths is not None:
        valid = torch.arange(t, device=u.device)[None, :] \
            < lengths.to(u.device)[:, None]
        dt = dt * valid[..., None]
        x = x * valid[..., None, None].to(x.dtype)
    return {"z": z, "xbc": xbc, "x": x, "dt": dt, "b": b, "c": c}


def ssd_block_apply(params, cfg, u: torch.Tensor, *,
                    chunk: Optional[int] = None, return_state: bool = False,
                    lengths: Optional[torch.Tensor] = None):
    """u: (B, T, d_model) -> (B, T, d_model) [, the decode state {"conv",
    "ssm"}].

    ``lengths`` (B,): right-padded prompts.  Padded positions get dt 0
    (decay 1, update 0: an inert recurrence step, as ``ssd_chunked`` pads
    its own chunks), so the returned ssm state is exactly the state after
    ``lengths[b]`` tokens; the conv window is gathered at each row's true
    end."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    ins = ssd_inputs(params, cfg, u, lengths)
    z, xbc = ins["z"], ins["xbc"]
    bsz, t = u.shape[0], u.shape[1]
    conv_state = None
    if return_state:
        kk = s.conv_kernel - 1
        if lengths is not None:
            conv_state = nn.gather_conv_window(xbc, lengths, kk)
        else:
            win = xbc[..., -kk:, :]
            pad = max(kk - xbc.shape[-2], 0)
            if pad:
                win = torch.cat([xbc.new_zeros(
                    xbc.shape[:-2] + (pad, xbc.shape[-1])), win], dim=-2)
            conv_state = win
    out = ssd_chunked(ins["x"], ins["dt"], params["a_log"], ins["b"],
                      ins["c"], params["d_skip"], chunk or s.chunk,
                      return_state=return_state, form=s.dual_form)
    y, ssm_state = out if return_state else (out, None)
    y = y.reshape(bsz, t, d_in)
    y = nn.rmsnorm_apply(params["out_norm"], y * F.silu(z))
    y = nn.dense_apply(params["out_proj"], y, cfg.cdtype)
    if return_state:
        return y, {"conv": conv_state, "ssm": ssm_state}
    return y


def ssd_block_init_state(cfg, batch: int, dtype=torch.float32,
                         device="cuda"):
    """The block's zero decode state {"conv" in ``dtype``, "ssm" fp32} on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1,
                             d_in + 2 * s.n_groups * s.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, s.n_heads(cfg.d_model), s.head_dim,
                            s.d_state), dtype=torch.float32, device=device),
    }


def ssd_block_step(params, cfg, u_t: torch.Tensor, state):
    """u_t: (B, d_model), one token -> (out (B, d_model), new state)."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    cd = cfg.cdtype
    z, x, b, c, dt = _split_proj(cfg, nn.dense_apply(params["in_proj"], u_t,
                                                     cd))
    xbc, conv_state = _conv_step(params["conv"], torch.cat([x, b, c], dim=-1),
                                 state["conv"])
    x, b, c = _conv_split(cfg, F.silu(xbc))
    bsz = x.shape[0]
    x = x.reshape(bsz, nh, s.head_dim)
    b = b.reshape(bsz, s.n_groups, s.d_state)
    c = c.reshape(bsz, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"][None, :])
    y, ssm_state = ssd_step(x, dt, params["a_log"], b, c, params["d_skip"],
                            state["ssm"])
    y = nn.rmsnorm_apply(params["out_norm"], y.reshape(bsz, d_in)
                         * F.silu(z))
    out = nn.dense_apply(params["out_proj"], y, cd)
    return out, {"conv": conv_state, "ssm": ssm_state}
