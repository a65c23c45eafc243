"""Attention mixers (``repro.models.attention``): GQA, blocked
(flash-style) for training and prefill, and single-token decode over a
KV cache; and deepseek-v3's MLA, which caches a latent ``c_kv`` and one
rotary key ``k_rope`` a position (not heads x head_dim), expands them for
training and prefill, and decodes in the latent space (the up
projections absorbed into the query and the output).

Blocked attention keeps the reference's tiling: the query axis in tiles
of ``q_chunk``, each running an online softmax in fp32 over the kv tiles
of ``kv_chunk`` it can see (kv padded to a tile multiple, masked by a
-1e30 bias; causal tiles past the tile's last query skipped).  The
kv-tile body runs under a non-reentrant ``torch.utils.checkpoint`` when
autograd records, as the reference's ``jax.checkpoint``: the backward
recomputes each (Tq, Tk) score tile, so a layer's saved activations are
O(T * tile), not O(T^2).

Both attention cores run in fp32 whatever the compute dtype: q, k and v
are upcast, and the output is cast back.  The reference keeps the raw
scores, p and the accumulator in the compute dtype; in bf16 at gemma-2b's
scale raw scores reach ~200, where a bf16 step is 1.0, and the prefill's
and the step path's logits then part by 6.7% of the largest after 18
layers on the card (the limit is 5%).  In fp32 nothing changes.

Everything here is plain PyTorch: the reference computes attention in
``jnp`` outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import nn
from repro_torch.models.rope import apply_rope, rope_tables, rotate

_NEG = -1e30


# ---------------------------------------------------------------------------
# GQA parameters
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg, *, dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bias = cfg.attn_bias
    return {
        "wq": nn.dense_init(gen, d, h * hd, use_bias=bias, dtype=dtype),
        "wk": nn.dense_init(gen, d, kv * hd, use_bias=bias, dtype=dtype),
        "wv": nn.dense_init(gen, d, kv * hd, use_bias=bias, dtype=dtype),
        "wo": nn.dense_init(gen, h * hd, d, use_bias=bias, dtype=dtype),
    }


# ---------------------------------------------------------------------------
# Blocked multi-head attention core
# ---------------------------------------------------------------------------

def _attend_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask_bias: Optional[torch.Tensor], scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (q-tile, kv-tile) step of online softmax.

    q: (B, Tq, K, G, D); k, v: (B, Tk, K, D).  Returns (m, l, o) updates."""
    s = torch.einsum("btkgd,bskd->bkgts", q, k).float() * scale
    if mask_bias is not None:
        s = s + mask_bias                      # (Tq, Tk) broadcast
    m = s.amax(dim=-1)                         # (B, K, G, Tq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype), v)
    return m, l, o


def _kv_step(q_tile, k_tile, v_tile, m_run, l_run, o_run, *, k0: int,
             tk: int, q_ids: Optional[torch.Tensor], scale: float):
    """Fold kv tile ``[k0, k0 + Tk)`` into the running (m, l, o)."""
    k_ids = k0 + torch.arange(k_tile.shape[1], device=k_tile.device)
    valid = (k_ids < tk)[None, :]
    if q_ids is not None:                      # causal
        valid = valid & (q_ids[:, None] >= k_ids[None, :])
    bias = torch.where(valid, 0.0, _NEG).float()
    m_new, l_new, o_new = _attend_tiles(q_tile, k_tile, v_tile, bias, scale)
    m_tot = torch.maximum(m_run, m_new)
    c_run = torch.exp(m_run - m_tot)
    c_new = torch.exp(m_new - m_tot)
    l_tot = l_run * c_run + l_new * c_new
    o_tot = (o_run * c_run[..., None].to(o_run.dtype)
             + o_new * c_new[..., None].to(o_new.dtype))
    return m_tot, l_tot, o_tot


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int = 1024,
                      kv_chunk: int = 1024, q_offset: int = 0
                      ) -> torch.Tensor:
    """q: (B, Tq, H, D); k, v: (B, Tk, KV, D) -> (B, Tq, H, D).

    ``q_offset`` positions q relative to k (prefill continuation).  Runs
    in fp32; the result comes back in q's dtype."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    bsz, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    q = q.reshape(bsz, tq, kv, g, d)
    q_chunk = min(q_chunk, tq)
    kv_chunk = min(kv_chunk, tk)
    # pad kv to a tile multiple; padded keys are masked by k_ids < tk
    pad_k = (-tk) % kv_chunk
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq = -(-tq // q_chunk)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    out_tiles = []
    for qi in range(nq):
        q0 = qi * q_chunk
        q_tile = q[:, q0:min(q0 + q_chunk, tq)]
        tq_t = q_tile.shape[1]
        q_pos_end = q_offset + q0 + tq_t        # exclusive
        # kv tiles this q tile can see
        nk_vis = -(-min(tk, q_pos_end) // kv_chunk) if causal \
            else -(-tk // kv_chunk)
        nk_vis = max(nk_vis, 1)
        q_ids = (q_offset + q0 + torch.arange(tq_t, device=q.device)) \
            if causal else None
        m = torch.full((bsz, kv, g, tq_t), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bsz, kv, g, tq_t), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((bsz, kv, g, tq_t, d), dtype=v.dtype,
                        device=q.device)
        for ki in range(nk_vis):
            k0 = ki * kv_chunk
            args = (q_tile, k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk],
                    m, l, o)
            kw = dict(k0=k0, tk=tk, q_ids=q_ids, scale=scale)
            if remat:
                # recompute the score tile in the backward instead of
                # saving it: the flash-attention memory trade
                m, l, o = torch.utils.checkpoint.checkpoint(
                    _kv_step, *args, **kw, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                m, l, o = _kv_step(*args, **kw)
        o = o / torch.clamp(l, min=1e-20)[..., None].to(o.dtype)
        out_tiles.append(o)                    # (B, KV, G, Tq_t, D)

    out = torch.cat(out_tiles, dim=3)          # (B, KV, G, Tq, D)
    return out.movedim(3, 1).reshape(bsz, tq, h, d).to(dtype)


# decode attention runs its rows in groups of this many, the last group
# padded: cuBLAS picks a batched product's kernel, and so a sum's order,
# by the batch count, so every product runs at one batch count whatever B
# is, and a row's result does not depend on B (the engine's greedy
# streams equal ``generate_one``'s, B 1, only so)
DECODE_ROWS = 8


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """Single-token attention. q: (B, H, D); caches: (B, S, KV, D); row b
    sees its first ``length[b]`` positions.  Runs in fp32, DECODE_ROWS
    rows a call; the result comes back in q's dtype."""
    bsz = q.shape[0]
    pad = (-bsz) % DECODE_ROWS
    if pad:
        q, k_cache, v_cache = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                               for t in (q, k_cache, v_cache))
        length = torch.cat([length, length.new_ones((pad,))])
    out = torch.cat([
        _decode_rows(q[i:i + DECODE_ROWS], k_cache[i:i + DECODE_ROWS],
                     v_cache[i:i + DECODE_ROWS], length[i:i + DECODE_ROWS])
        for i in range(0, bsz + pad, DECODE_ROWS)])
    return out[:bsz]


def _decode_rows(q, k_cache, v_cache, length):
    dtype = q.dtype
    q, k_cache, v_cache = q.float(), k_cache.float(), v_cache.float()
    bsz, h, d = q.shape
    kv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(bsz, kv, h // kv, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(pos[None, None, None, :] < length[:, None, None, None],
                    s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return o.reshape(bsz, h, d).to(dtype)


# ---------------------------------------------------------------------------
# GQA apply (parallel / decode)
# ---------------------------------------------------------------------------

def _project(p, x, cfg, n_heads):
    """x: (..., d_model) -> (..., n_heads, head_dim)."""
    y = nn.dense_apply(p, x, cfg.cdtype)
    return y.reshape(y.shape[:-1] + (n_heads, cfg.head_dim_))


def gqa_apply(params, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention. kv != None -> cross attention over kv."""
    bsz, t, _ = x.shape
    q = _project(params["wq"], x, cfg, cfg.n_heads)
    if kv is None:
        k = _project(params["wk"], x, cfg, cfg.n_kv_heads)
        v = _project(params["wv"], x, cfg, cfg.n_kv_heads)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv
    o = blocked_attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk, q_offset=q_offset)
    return nn.dense_apply(params["wo"], o.reshape(bsz, t, -1), cfg.cdtype)


def gqa_project_kv(params, cfg, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None):
    """Project k, v for caching (self) or cross-attention (encoder out)."""
    k = _project(params["wk"], x, cfg, cfg.n_kv_heads)
    v = _project(params["wv"], x, cfg, cfg.n_kv_heads)
    if cfg.rope and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_prefill(params, cfg, x: torch.Tensor, *, positions: torch.Tensor):
    """Causal self-attention over the prompt; returns (out, k, v) so the
    caches can be seeded for decode."""
    bsz, t, _ = x.shape
    q = _project(params["wq"], x, cfg, cfg.n_heads)
    k, v = gqa_project_kv(params, cfg, x)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)
    out = nn.dense_apply(params["wo"], o.reshape(bsz, t, -1), cfg.cdtype)
    return out, k, v


def decode_tables(cfg, pos: torch.Tensor, max_len: int,
                  rope_dim: Optional[int] = None) -> dict:
    """What every layer of one decode step shares, built once for the
    step: the RoPE tables at ``pos`` over ``rope_dim`` rotated channels
    (the head size unless given: MLA rotates ``mla_rope_dim``) and the
    cache rows it writes (``_cache_insert``'s slots)."""
    tables = {"slots": cache_slots(pos, max_len)}
    if cfg.rope:
        tables["rope"] = rope_tables(pos[:, None], rope_dim or cfg.head_dim_,
                                     cfg.rope_theta)
    return tables


def gqa_decode_step(params, cfg, x_t: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: torch.Tensor, *,
                    tables: Optional[dict] = None,
                    rows: Optional[int] = None):
    """x_t: (B, d_model); caches (B, S, KV, D); pos: (B,) current index.

    Returns (out_t, k_cache, v_cache): the new token's k and v are written
    into the caches in place (``_cache_insert``), which come back.
    ``tables``: the step's ``decode_tables``, if the caller holds them.
    ``rows`` (``DECODE_ROWS``): the four projections in tiles of that
    many rows, the last padded, so a row's result does not depend on B."""
    bsz = x_t.shape[0]
    if tables is None:
        tables = decode_tables(cfg, pos, k_cache.shape[1])

    def proj(name, n_heads):
        return nn.tiled(lambda t: _project(params[name], t, cfg, n_heads),
                        x_t, rows)

    q = proj("wq", cfg.n_heads)
    k = proj("wk", cfg.n_kv_heads)
    v = proj("wv", cfg.n_kv_heads)
    if cfg.rope:
        q = rotate(q[:, None], *tables["rope"])[:, 0]
        k = rotate(k[:, None], *tables["rope"])[:, 0]
    _cache_insert(k_cache, k, pos, tables["slots"])
    _cache_insert(v_cache, v, pos, tables["slots"])
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    out = nn.tiled(lambda t: nn.dense_apply(params["wo"], t, cfg.cdtype),
                   o.reshape(bsz, -1), rows)
    return out, k_cache, v_cache


def cache_slots(pos: torch.Tensor, max_len: int):
    """(rows, positions clamped into the cache, whether each is inside)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, pos.long().clamp(0, max_len - 1), pos < max_len


def _cache_insert(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor, slots=None) -> torch.Tensor:
    """cache: (B, S, ...); new: (B, ...); pos: (B,) -- in place, row b's
    position pos[b] <- new[b].  The reference blends a one-hot over the
    whole cache, which multiplies by exact 0s and 1s: the same values for
    finite entries, without rewriting (B, S, ...) a step.  A position at
    or past S is left as it is, as the all-zero one-hot leaves it (a dead
    serving row keeps stepping).  ``slots``: ``cache_slots(pos, S)``, if
    the caller holds them."""
    rows, idx, inside = slots if slots is not None \
        else cache_slots(pos, cache.shape[1])
    inside = inside.reshape((-1,) + (1,) * (new.ndim - 1))
    cache[rows, idx] = torch.where(inside, new.to(cache.dtype),
                                   cache[rows, idx])
    return cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, *, dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.mla_q_lora, cfg.mla_kv_lora
    nope, rope_d, vd = cfg.mla_qk_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {
        "wq_a": nn.dense_init(gen, d, qr, use_bias=False, dtype=dtype),
        "q_norm": nn.rmsnorm_init(qr, dtype),
        "wq_b": nn.dense_init(gen, qr, h * (nope + rope_d), use_bias=False,
                              dtype=dtype),
        "wkv_a": nn.dense_init(gen, d, kvr + rope_d, use_bias=False,
                               dtype=dtype),
        "kv_norm": nn.rmsnorm_init(kvr, dtype),
        "wk_b": nn.dense_init(gen, kvr, h * nope, use_bias=False,
                              dtype=dtype),
        "wv_b": nn.dense_init(gen, kvr, h * vd, use_bias=False, dtype=dtype),
        "wo": nn.dense_init(gen, h * vd, d, use_bias=False, dtype=dtype),
    }


def _mla_q(params, cfg, x):
    """x: (..., d) -> q (..., H, nope + rope_dim), not yet rotated."""
    cd = cfg.cdtype
    q = nn.dense_apply(params["wq_b"], nn.rmsnorm_apply(
        params["q_norm"], nn.dense_apply(params["wq_a"], x, cd)), cd)
    return q.reshape(q.shape[:-1] + (cfg.n_heads, -1))


def _mla_kv(params, cfg, x):
    """x: (..., d) -> (..., kv_lora + rope_dim): the normed latent c_kv,
    then the rotary key k_rope (one for all heads), not yet rotated."""
    kvr = cfg.mla_kv_lora
    kv = nn.dense_apply(params["wkv_a"], x, cfg.cdtype)
    return torch.cat([nn.rmsnorm_apply(params["kv_norm"], kv[..., :kvr]),
                      kv[..., kvr:]], dim=-1)


def _mla_split(cfg, q, kv, rope):
    """(q_nope, q_rope, c_kv, k_rope), the rotary parts rotated by
    ``rope``'s (cos, sin) tables."""
    nope, kvr = cfg.mla_qk_nope_dim, cfg.mla_kv_lora
    return (q[..., :nope], rotate(q[..., nope:], *rope), kv[..., :kvr],
            rotate(kv[..., kvr:], *rope))


def _mla_expanded(params, cfg, x, positions, causal):
    """The training / prefill form: the latent expanded into per-head
    k_nope and v, k_rope broadcast over the heads, v padded to the qk
    head size so blocked attention sees one head size.  Returns (out,
    c_kv, k_rope)."""
    bsz, t, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.mla_qk_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    cd = cfg.cdtype
    rope = rope_tables(positions, cfg.mla_rope_dim, cfg.rope_theta)
    q_nope, q_rope, c_kv, k_rope = _mla_split(
        cfg, _mla_q(params, cfg, x), _mla_kv(params, cfg, x), rope)
    k_nope = nn.dense_apply(params["wk_b"], c_kv, cd).reshape(bsz, t, h, nope)
    v = nn.dense_apply(params["wv_b"], c_kv, cd).reshape(bsz, t, h, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(bsz, t, h, rope_d)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = torch.nn.functional.pad(v, (0, nope + rope_d - vd))
    o = blocked_attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)[..., :vd]
    out = nn.dense_apply(params["wo"], o.reshape(bsz, t, h * vd), cd)
    return out, c_kv, k_rope


def mla_apply(params, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Training / prefill MLA: expand the latent and run blocked
    attention (in fp32, as the GQA core)."""
    return _mla_expanded(params, cfg, x, positions, causal)[0]


def mla_prefill(params, cfg, x: torch.Tensor, *, positions: torch.Tensor):
    """MLA prefill; returns (out, c_kv, k_rope): the latent caches."""
    return _mla_expanded(params, cfg, x, positions, True)


def mla_decode_step(params, cfg, x_t: torch.Tensor, ckv_cache: torch.Tensor,
                    krope_cache: torch.Tensor, pos: torch.Tensor, *,
                    tables: Optional[dict] = None,
                    rows: Optional[int] = None):
    """Absorbed-latent decode: attend in the compressed kv space.

    x_t: (B, d_model); ckv_cache: (B, S, kv_lora); krope_cache: (B, S,
    rope_dim); pos: (B,).  The new token's c_kv and k_rope are written
    into the caches in place (``_cache_insert``), which come back.  The
    up projections are absorbed: q_lat = q_nope wk_b^T per head, scores
    q_lat c_kv + q_rope k_rope, then p c_kv and wv_b, wo -- in fp32,
    ``DECODE_ROWS`` rows a call, the last call padded, as
    ``decode_attention``; the mask is -inf past a row's ``pos``, as the
    reference's (every row sees position 0).  ``rows``: the projections
    in tiles of that many rows."""
    bsz = x_t.shape[0]
    if tables is None:
        tables = decode_tables(cfg, pos, ckv_cache.shape[1],
                               cfg.mla_rope_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_split(
        cfg, nn.tiled(lambda t: _mla_q(params, cfg, t), x_t, rows),
        nn.tiled(lambda t: _mla_kv(params, cfg, t), x_t, rows),
        [a[:, 0] for a in tables["rope"]])
    _cache_insert(ckv_cache, c_kv, pos, tables["slots"])
    _cache_insert(krope_cache, k_rope, pos, tables["slots"])
    h = cfg.n_heads
    wk_b = params["wk_b"]["kernel"].float().reshape(cfg.mla_kv_lora, h, -1)
    wv_b = params["wv_b"]["kernel"].float().reshape(cfg.mla_kv_lora, h, -1)
    q_nope = q_nope.reshape(bsz, h, -1)
    q_rope = q_rope.reshape(bsz, h, -1)
    length = pos + 1
    pad = (-bsz) % DECODE_ROWS
    if pad:
        q_nope, q_rope, ckv, krope = (
            torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            for t in (q_nope, q_rope, ckv_cache, krope_cache))
        length = torch.cat([length, length.new_ones((pad,))])
    else:
        ckv, krope = ckv_cache, krope_cache
    scale = 1.0 / math.sqrt(cfg.mla_qk_nope_dim + cfg.mla_rope_dim)
    o = torch.cat([
        _mla_decode_rows(*(a[i:i + DECODE_ROWS] for a in (
            q_nope, q_rope, ckv, krope, length)), wk_b, wv_b, scale)
        for i in range(0, bsz + pad, DECODE_ROWS)])[:bsz]
    out = nn.tiled(lambda t: nn.dense_apply(params["wo"], t, cfg.cdtype),
                   o.reshape(bsz, -1).to(cfg.cdtype), rows)
    return out, ckv_cache, krope_cache


def _mla_decode_rows(q_nope, q_rope, ckv, krope, length, wk_b, wv_b, scale):
    """One tile of the absorbed decode in fp32: q_nope (b, H, nope),
    q_rope (b, H, rope_dim), caches (b, S, .) -> (b, H, v_dim)."""
    q_lat = torch.einsum("bhn,khn->bhk", q_nope.float(), wk_b)
    s = (torch.einsum("bhk,bsk->bhs", q_lat, ckv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope.float())
         ) * scale
    idx = torch.arange(ckv.shape[1], device=ckv.device)
    s = torch.where(idx[None, None, :] < length[:, None, None], s,
                    float("-inf"))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsk->bhk", p, ckv.float())
    return torch.einsum("bhk,khv->bhv", o_lat, wv_b)
