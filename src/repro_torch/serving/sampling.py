"""Token sampling with per-slot controls and JAX-identical key chains.

Semantics as ``repro.serving.sampling``: ``temperature <= 0`` is an exact
greedy argmax; otherwise categorical over ``softmax(logits / T)`` after
top-k (ties at the k-th value kept) and nucleus (top-p) filtering.

Keys.  The reference keeps a threefry2x32 key per slot, made by
``make_keys`` (``fold_in`` of ``PRNGKey(seed)``) and advanced by one
``split`` on every round the slot emits; a sampled token is
``argmax(masked_logits + gumbel(use_key))``.  This module ports
threefry2x32, ``fold_in``, ``split`` and the Gumbel draw as integer tensor
ops -- uint32 arithmetic carried in int64 and masked to 32 bits -- so the
key chains are bit-identical to JAX's (the installed JAX's default,
partitionable, counter layout).  Because a key advances only when its
slot emits, the noise of the next n chain positions can be drawn ahead on
the host (``gumbel_table``); the device round then just gathers the row
at the slot's emission count.  Under speculation a slot may emit up to
S + 1 tokens a round, so the table covers n (S + 1) positions and a
round gathers S + 1 consecutive planes from the slot's count
(``chain_tokens``); ``sample_chain`` is the reference's chained sampler.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30          # "removed from support" without -inf NaN risk
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def validate_controls(temperature: float, top_k: int, top_p: float) -> None:
    """Reject malformed per-request sampling controls at submission."""
    if not math.isfinite(temperature) or temperature < 0:
        raise ValueError(
            f"temperature must be finite and >= 0 (0 = greedy), "
            f"got {temperature!r}")
    if int(top_k) != top_k or top_k < 0:
        raise ValueError(
            f"top_k must be a non-negative integer (0 disables the "
            f"filter), got {top_k!r}")
    if not math.isfinite(top_p) or not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1] (1 disables nucleus sampling), "
            f"got {top_p!r}")


# ---------------------------------------------------------------------------
# threefry2x32 (uint32 lanes carried in int64 tensors)
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash, 20 rounds, as JAX lowers it.  All inputs
    are int64 tensors (broadcastable) holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _hash_counter(keys, lo):
    """threefry(key, (0, lo)) for keys (..., 2): the counter form shared
    by ``fold_in``, ``split`` and the random bits of a (V,) draw."""
    return threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(lo), lo)


def make_keys(seed: int, batch: int) -> torch.Tensor:
    """Per-slot keys ``fold_in(PRNGKey(seed % (2**31 - 1)), i)``: (batch,
    2) int64 holding uint32 key data, on the host."""
    base = torch.tensor([0, int(seed) % (2**31 - 1)], dtype=torch.int64)
    i = torch.arange(batch, dtype=torch.int64)
    o1, o2 = _hash_counter(base[None, :], i)
    return torch.stack([o1, o2], dim=-1)


def split(keys: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.split)(keys)``: (..., 2) -> (..., 2, 2)."""
    lo = torch.arange(2, dtype=torch.int64, device=keys.device)
    o1, o2 = _hash_counter(keys[..., None, :], lo)
    return torch.stack([o1, o2], dim=-1)


def advance_keys(keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Apply ``steps[b]`` chain advances (``split(key)[0]``) to row b."""
    steps = steps.to(torch.int64).cpu()
    keys = keys.clone()
    for i in range(int(steps.max()) if steps.numel() else 0):
        adv = split(keys)[..., 0, :]
        keys = torch.where((i < steps)[:, None], adv, keys)
    return keys


def uniform(use_keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """``jax.random.uniform(key, (vocab,), minval=tiny, maxval=1)`` per
    key, bit for bit: (..., 2) -> (..., vocab) fp32."""
    lo = torch.arange(vocab, dtype=torch.int64, device=use_keys.device)
    o1, o2 = _hash_counter(use_keys[..., None, :], lo)
    bits = o1 ^ o2
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return torch.clamp(floats * (1.0 - _TINY) + _TINY, min=_TINY)


def gumbel(use_keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (vocab,))`` (low mode, fp32) per key:
    -log(-log(u)) of :func:`uniform`.  The uniforms are JAX's bits; the
    two logs may differ from XLA's in the last ulp."""
    return -torch.log(-torch.log(uniform(use_keys, vocab)))


def _chain(keys: torch.Tensor, n: int):
    """The next ``n`` positions of each slot's chain: (use keys, keys
    after), each (B, n, 2).  Position e samples with ``split(chain[e])[1]``
    and leaves ``chain[e + 1] = split(chain[e])[0]``, chain[0] = keys."""
    uses, after = [], []
    k = keys
    for _ in range(n):
        s = split(k)
        uses.append(s[..., 1, :])
        k = s[..., 0, :]
        after.append(k)
    return torch.stack(uses, dim=1), torch.stack(after, dim=1)


def gumbel_table(keys: torch.Tensor, n: int, vocab: int) -> torch.Tensor:
    """Noise of the next ``n`` chain positions per slot: (B, n, vocab),
    position e the noise a slot's (e+1)-th emission of the coming rounds
    samples with."""
    return gumbel(_chain(keys, n)[0], vocab)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _support_mask(logits, top_k, top_p):
    """Top-k then nucleus filtering with one descending sort; both keep a
    prefix of the sorted row, so threshold against its last element."""
    v = logits.shape[-1]
    neg = torch.tensor(_NEG, dtype=logits.dtype, device=logits.device)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.clamp(1, v).to(torch.int64)
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    kth = torch.where((top_k > 0)[:, None], kth, neg)
    keep_k = sorted_desc >= kth
    probs = torch.softmax(torch.where(keep_k, sorted_desc, neg), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep_p = ((csum - probs) < top_p[:, None]) | (top_p >= 1.0)[:, None]
    count = torch.clamp((keep_k & keep_p).sum(dim=-1), min=1)
    cutoff = torch.gather(sorted_desc, -1, (count - 1)[:, None])
    return torch.where(logits >= cutoff, logits, neg)


def sample_tokens(logits: torch.Tensor, gumbel_noise, temperature,
                  top_k, top_p) -> torch.Tensor:
    """logits: (B, V); gumbel_noise: (B, V) from ``gumbel_table`` or None
    when no row samples; temperature / top_p (B,) fp32, top_k (B,) int.
    Returns (B,) int32 tokens: greedy argmax where temperature <= 0."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if gumbel_noise is None:
        return greedy
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    scaled = _support_mask(scaled, top_k, top_p)
    sampled = torch.argmax(scaled + gumbel_noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def chain_tokens(logits: torch.Tensor, gumbel_noise, temperature, top_k,
                 top_p) -> torch.Tensor:
    """logits (B, W, V); gumbel_noise (B, W, V) or None when no row
    samples -> (B, W) int32: position i sampled as the i-th of W
    sequential :func:`sample_tokens` calls, with noise plane i."""
    if gumbel_noise is None:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return torch.stack([
        sample_tokens(logits[:, i], gumbel_noise[:, i], temperature, top_k,
                      top_p) for i in range(logits.shape[1])], dim=1)


def sample_chain(logits: torch.Tensor, keys: torch.Tensor, temperature,
                 top_k, top_p):
    """Chained per-position sampling for speculative verify, as the
    reference's ``sample_chain``: logits (B, W, V), keys (B, 2) ->
    (tokens (B, W) int32, keys_after (B, W, 2)).  Position i is sampled
    as the i-th of W sequential ``sample_tokens`` rounds would be, and
    ``keys_after[:, i]`` is the key after i + 1 splits.  The keys live on
    the host (int64 holding uint32); the noise moves to the logits'
    device."""
    uses, after = _chain(keys, logits.shape[1])
    noise = gumbel(uses, logits.shape[-1]).to(logits.device)
    return chain_tokens(logits, noise, temperature, top_k, top_p), after
