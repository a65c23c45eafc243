"""Whisper-style encoder-decoder (``repro.models.encdec``): whisper-base.

The conv / mel frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, T_enc, frontend_dim) and projects
them (``frame_proj``).  The backbone follows the reference: LayerNorm,
a plain GELU MLP, biased attention, learned positional embeddings
(``enc_pos``, ``dec_pos``), a bidirectional encoder, and a causal
decoder with cross-attention; the output projection is tied to the
embedding.  Decode caches the self-attention k / v a step (written in
place, as the LM's KV cache) and the cross-attention k / v once, at
``prefill``.

Params keep the JAX pytree's layout (``frame_proj``, ``enc_pos.table``,
``embed.table``, ``dec_pos.table``, ``encoder.*`` and ``decoder.*``
stacked with a leading layer axis, ``enc_norm``, ``final_norm``) so
``bridge.params_from_jax`` carries them leaf by leaf.  Each layer's
forward runs under ``torch.utils.checkpoint`` when ``cfg.remat ==
"full"``.  The decode step runs its norms, projections, attention and
MLP in tiles of ``attention.DECODE_ROWS`` rows, so a decode row does not
depend on B.  Everything here is plain PyTorch: the reference runs this
model outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import nn
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.mlp import mlp_apply, mlp_init

N_AUDIO_FRAMES = 1500        # whisper's 30 s / 20 ms frame count


def _check_cfg(cfg):
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} is not an encoder-decoder (family "
                         f"{cfg.family!r}): its model is models/lm.py")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _mlp_init(gen, cfg, dtype):
    return mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                    bias=cfg.mlp_bias, dtype=dtype)


def _enc_layer_init(gen, cfg, dtype):
    return {"norm1": nn.norm_init(cfg.norm, cfg.d_model, dtype),
            "attn": attn.gqa_init(gen, cfg, dtype=dtype),
            "norm2": nn.norm_init(cfg.norm, cfg.d_model, dtype),
            "mlp": _mlp_init(gen, cfg, dtype)}


def _dec_layer_init(gen, cfg, dtype):
    return {"norm1": nn.norm_init(cfg.norm, cfg.d_model, dtype),
            "self_attn": attn.gqa_init(gen, cfg, dtype=dtype),
            "norm_x": nn.norm_init(cfg.norm, cfg.d_model, dtype),
            "cross_attn": attn.gqa_init(gen, cfg, dtype=dtype),
            "norm2": nn.norm_init(cfg.norm, cfg.d_model, dtype),
            "mlp": _mlp_init(gen, cfg, dtype)}


def init_params(gen: torch.Generator, cfg, device="cuda") -> Dict[str, Any]:
    """Seeded random init in the reference's layout, drawn on ``gen``'s
    device a layer at a time (``lm._stack_init``), then moved to
    ``device``.  The numbers differ from ``jax.random``'s; tests that
    compare the two packages bridge the JAX weights instead."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    dtype, d = cfg.pdtype, cfg.d_model
    params = {
        "frame_proj": nn.dense_init(gen, cfg.frontend_dim, d, dtype=dtype),
        "enc_pos": {"table": nn.normal_init(
            gen, (cfg.n_frontend_tokens, d), 0.01, dtype)},
        "embed": {"table": nn.normal_init(
            gen, (cfg.padded_vocab, d), 0.02, dtype)},
        "dec_pos": {"table": nn.normal_init(
            gen, (cfg.max_seq_len, d), 0.01, dtype)},
        "encoder": lm._stack_init(lambda: _enc_layer_init(gen, cfg, dtype),
                                  cfg.n_encoder_layers),
        "enc_norm": nn.norm_init(cfg.norm, d, dtype),
        "decoder": lm._stack_init(lambda: _dec_layer_init(gen, cfg, dtype),
                                  cfg.n_layers),
        "final_norm": nn.norm_init(cfg.norm, d, dtype),
    }
    return lm.tree_to(params, dev)


def _mlp(p, cfg, y):
    return mlp_apply(p["mlp"], y, activation=cfg.mlp_activation,
                     compute_dtype=cfg.cdtype)


def _logits(params, cfg, x):
    """The final norm, then the output projection tied to the embedding
    (whisper's), the pad columns masked."""
    x = lm._norm(cfg, params["final_norm"], x)
    return lm.mask_pad_vocab(
        cfg, x @ params["embed"]["table"].to(cfg.cdtype).T)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, frontend_dim) stub embeddings -> (B, T_enc, d):
    bidirectional self-attention (no RoPE) and the MLP per layer."""
    x = nn.dense_apply(params["frame_proj"], frames, cfg.cdtype)
    x = x + params["enc_pos"]["table"][None, :x.shape[1]].to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x_, p_l):
        y = lm._norm(cfg, p_l["norm1"], x_)
        x_ = x_ + attn.gqa_apply(p_l["attn"], cfg, y, positions=positions,
                                 causal=False)
        return x_ + _mlp(p_l, cfg, lm._norm(cfg, p_l["norm2"], x_))

    body = lm._remat(cfg, body)
    for p_l in lm.unstack(params["encoder"]):
        x = body(x, p_l)
    return lm._norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# decoder (parallel / teacher-forced)
# ---------------------------------------------------------------------------

def _dec_block_apply(p, cfg, x, enc_kv, positions):
    y = lm._norm(cfg, p["norm1"], x)
    x = x + attn.gqa_apply(p["self_attn"], cfg, y, positions=positions,
                           causal=True)
    y = lm._norm(cfg, p["norm_x"], x)
    x = x + attn.gqa_apply(p["cross_attn"], cfg, y, positions=positions,
                           causal=False, kv=enc_kv)
    return x + _mlp(p, cfg, lm._norm(cfg, p["norm2"], x))


def _embed(params, cfg, tokens, pos):
    """Token embeddings plus the learned decoder positions ``pos``,
    clamped into the table's ``max_seq_len`` rows as the reference's
    gather clamps them: a decode step at or past the last learned
    position reuses that position's row."""
    x = params["embed"]["table"].to(cfg.cdtype)[tokens.long()]
    table = params["dec_pos"]["table"]
    idx = pos.long().clamp(0, table.shape[0] - 1)
    return x + table.to(cfg.cdtype)[idx]


def forward(params, cfg, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: frames (B, T_enc, frontend_dim), tokens (B,
    S) -> logits (B, S, V) in the compute dtype."""
    _check_cfg(cfg)
    enc = encode(params, cfg, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens, positions)

    def body(x_, p_l, enc_):
        kv = attn.gqa_project_kv(p_l["cross_attn"], cfg, enc_)
        return _dec_block_apply(p_l, cfg, x_, kv, positions)

    body = lm._remat(cfg, body)
    for p_l in lm.unstack(params["decoder"]):
        x = body(x, p_l, enc)
    return _logits(params, cfg, x)


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor]):
    """batch: frames (B, T_enc, frontend_dim), tokens (B, S), labels (B,
    S) with -1 = ignore -> (token-mean NLL in fp32, detached metrics)."""
    logits = forward(params, cfg, batch["frames"], batch["tokens"]).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss.detach(), "nll": loss.detach(),
                  "ntokens": mask.sum()}


# ---------------------------------------------------------------------------
# decode (self-attention kv cached a step; cross kv computed at prefill)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
    """``pos`` (B,), the self-attention ``k`` / ``v`` (L, B, max_len, KV,
    head_dim) and the cross-attention ``cross_k`` / ``cross_v`` (L, B,
    n_frontend_tokens, KV, head_dim), in the compute dtype."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    dt = cfg.cdtype
    kv, hd = cfg.n_kv_heads, cfg.head_dim_

    def zeros(t):
        return torch.zeros((cfg.n_layers, batch, t, kv, hd), dtype=dt,
                           device=dev)

    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(cfg.n_frontend_tokens),
            "cross_v": zeros(cfg.n_frontend_tokens)}


@torch.no_grad()
def prefill(params, cfg, frames: torch.Tensor,
            cache: Dict[str, Any]) -> Dict[str, Any]:
    """Encode the frames and compute every decoder layer's cross-attention
    k / v once; returns the cache with them (the rest as it was)."""
    _check_cfg(cfg)
    enc = encode(params, cfg, frames)
    kvs = [attn.gqa_project_kv(p_l["cross_attn"], cfg, enc)
           for p_l in lm.unstack(params["decoder"])]
    cache = dict(cache)
    cache["cross_k"] = torch.stack([k for k, _ in kvs])
    cache["cross_v"] = torch.stack([v for _, v in kvs])
    return cache


@torch.no_grad()
def decode_step(params, cfg, token: torch.Tensor, cache: Dict[str, Any]):
    """token: (B,) -> (logits (B, V), new cache): per decoder layer norm,
    self-attention against the KV cache (the new k / v written in place),
    norm, cross-attention over ``cross_k`` / ``cross_v``, norm, MLP; each
    with a residual.  Every norm and product runs in tiles of
    ``attention.DECODE_ROWS`` rows, so a row's logits do not depend on
    B."""
    _check_cfg(cfg)
    rows = attn.DECODE_ROWS
    pos = cache["pos"]
    bsz = token.shape[0]
    x = _embed(params, cfg, token, pos)
    tables = attn.decode_tables(cfg, pos, cache["k"].shape[2])
    t_enc = torch.full((bsz,), cache["cross_k"].shape[2], dtype=torch.int32,
                       device=token.device)

    def tiled(fn, a):
        return nn.tiled(fn, a, rows)

    for i, p_l in enumerate(lm.unstack(params["decoder"])):
        y = tiled(lambda t: lm._norm(cfg, p_l["norm1"], t), x)
        out, _, _ = attn.gqa_decode_step(p_l["self_attn"], cfg, y,
                                         cache["k"][i], cache["v"][i], pos,
                                         tables=tables, rows=rows)
        x = x + out
        cross = p_l["cross_attn"]
        y = tiled(lambda t: lm._norm(cfg, p_l["norm_x"], t), x)
        q = tiled(lambda t: attn._project(cross["wq"], t, cfg, cfg.n_heads),
                  y)
        o = attn.decode_attention(q, cache["cross_k"][i],
                                  cache["cross_v"][i], t_enc)
        x = x + tiled(lambda t: nn.dense_apply(cross["wo"], t, cfg.cdtype),
                      o.reshape(bsz, -1))
        y = tiled(lambda t: lm._norm(cfg, p_l["norm2"], t), x)
        x = x + tiled(lambda t: _mlp(p_l, cfg, t), y)
    logits = tiled(lambda t: _logits(params, cfg, t), x)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache
