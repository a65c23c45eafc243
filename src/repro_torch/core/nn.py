"""Minimal functional NN building blocks (``repro.core.nn`` subset).

Parameters are plain nested dicts of tensors.  Initializers draw from an
explicit ``torch.Generator`` on that generator's device: a CPU generator
gives the same weights whatever device they are moved to; a CUDA one
draws on the card, where a model too large for a host-side draw is made.
The apply functions run on the device of their inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import fake_mode


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32,
                 in_axis: int = 0) -> torch.Tensor:
    std = math.sqrt(1.0 / max(1, shape[in_axis]))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if fake_mode() is None:         # a fake trace takes the shapes alone
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def normal_init(gen: torch.Generator, shape, std,
                dtype=torch.float32) -> torch.Tensor:
    return (std * torch.randn(shape, generator=gen, device=gen.device)
            ).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, *, use_bias: bool = True,
               dtype=torch.float32, bias_init: float = 0.0):
    p = {"kernel": lecun_normal(gen, (in_dim, out_dim), dtype)}
    if use_bias:
        p["bias"] = torch.full((out_dim,), bias_init, dtype=dtype,
                               device=gen.device)
    return p


def dense_apply(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    k = p["kernel"]
    if compute_dtype is not None:
        k = k.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ k
    if "bias" in p:
        b = p["bias"]
        if compute_dtype is not None:
            b = b.to(compute_dtype)
        y = y + b
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6,
                  zero_centered: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    if zero_centered:
        scale = 1.0 + scale
    return (y * scale).to(dtype)


def layernorm_init(dim: int, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype),
            "bias": torch.zeros((dim,), dtype=dtype)}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's arithmetic: fp32 mean and population variance,
    ``rsqrt(var + eps)``, scale and bias in fp32, one cast back."""
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


def norm_init(kind: str, dim: int, dtype=torch.float32):
    if kind == "rmsnorm":
        return rmsnorm_init(dim, dtype)
    if kind == "layernorm":
        return layernorm_init(dim, dtype)
    raise ValueError(kind)


def norm_apply(kind: str, p, x: torch.Tensor, **kw) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(p, x, **kw)
    if kind == "layernorm":
        return layernorm_apply(p, x, **kw)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Causal depthwise conv (the paper's "Conv4" temporal mixer)
# ---------------------------------------------------------------------------

def causal_conv_init(gen, dim: int, kernel_size: int = 4,
                     dtype=torch.float32):
    std = math.sqrt(1.0 / kernel_size)
    return {"kernel": normal_init(gen, (kernel_size, dim), std, dtype),
            "bias": torch.zeros((dim,), dtype=dtype)}


def causal_conv_apply(p, x: torch.Tensor,
                      prefix: torch.Tensor = None) -> torch.Tensor:
    """x: (..., T, D) depthwise causal conv along T, in x's dtype.

    ``prefix`` (default zeros) is the (..., K-1, D) window of inputs that
    precede ``x``.  The reference's unrolled slide-multiply-add: K adds of
    shifted slices, each product and sum rounded to x's dtype."""
    k = p["kernel"].to(x.dtype)              # (K, D)
    ksize = k.shape[0]
    if prefix is None:
        prefix = x.new_zeros(x.shape[:-2] + (ksize - 1, x.shape[-1]))
    xp = torch.cat([prefix.to(x.dtype), x], dim=-2)
    t = x.shape[-2]
    y = torch.zeros_like(x)
    for i in range(ksize):
        y = y + xp[..., i:i + t, :] * k[i]
    return y + p["bias"].to(x.dtype)


def causal_conv_step(p, x_t: torch.Tensor, conv_state: torch.Tensor):
    """Single decode step. conv_state: (..., K-1, D) trailing inputs."""
    k = p["kernel"].to(x_t.dtype)
    window = torch.cat([conv_state, x_t[..., None, :]], dim=-2)
    y = torch.einsum("...kd,kd->...d", window, k) \
        + p["bias"].to(x_t.dtype)
    return y, window[..., 1:, :]


def pad_to(a: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """a with zeros appended along ``dim`` up to ``rows``."""
    pad = list(a.shape)
    pad[dim] = rows - a.shape[dim]
    return torch.cat([a, a.new_zeros(pad)], dim=dim)


def tiled(fn, x: torch.Tensor, rows, dim: int = 0) -> torch.Tensor:
    """``fn(x)`` for a row-wise ``fn``, with x cut along ``dim`` into tiles
    of ``rows`` (the last padded with zeros, its padding dropped from the
    result), so every call sees the same row count whatever x's; ``rows``
    None or x one tile already: one plain call."""
    n = x.shape[dim]
    if rows is None or n == rows:
        return fn(x)
    outs = []
    for i in range(0, n, rows):
        part = x.narrow(dim, i, min(rows, n - i))
        m = part.shape[dim]
        if m < rows:
            part = pad_to(part, rows, dim)
        outs.append(fn(part).narrow(dim, 0, m))
    return torch.cat(outs, dim=dim)


def gather_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: (B, T, ...) -> (B, ...), row b taken at position lengths[b]-1."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, lengths.long() - 1]


def gather_conv_window(x: torch.Tensor, lengths: torch.Tensor, width: int,
                       prefix: torch.Tensor = None) -> torch.Tensor:
    """Trailing ``width`` inputs after consuming ``lengths[b]`` tokens.

    x: (B, T, D) -> (B, width, D): rows [len - width, len - 1] of
    ``concat(prefix, x)``, where ``prefix`` (default zeros) holds the
    ``width`` inputs that preceded ``x`` (the carried conv window on
    resume)."""
    bsz = x.shape[0]
    if prefix is None:
        prefix = x.new_zeros((bsz, width) + tuple(x.shape[2:]))
    ext = torch.cat([prefix.to(x.dtype), x], dim=1)
    idx = lengths.long()[:, None] + torch.arange(width, device=x.device)
    rows = torch.arange(bsz, device=x.device)[:, None]
    return ext[rows, idx]


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu, "silu": F.silu}


def g(x: torch.Tensor) -> torch.Tensor:
    """g(x) = x + 0.5 if x >= 0 else sigmoid(x); ensures h_tilde > 0."""
    return torch.where(x >= 0, x + 0.5, torch.sigmoid(x))


def log_g(x: torch.Tensor) -> torch.Tensor:
    """log g(x), computed stably: log(x+0.5) / -softplus(-x)."""
    return torch.where(x >= 0, torch.log(F.relu(x) + 0.5),
                       -F.softplus(-x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigma(x) = -softplus(-x)."""
    return -F.softplus(-x)
