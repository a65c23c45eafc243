"""Draft-token sources for speculative decoding in the serving superstep
(the port of ``repro.serving.draft``).

Verifying S draft tokens is one pass through the varlen chunk kernels
(``lm.decode_verify``: one launch per layer, the weights read once), and
rolling back to the first rejected position is a gather of that pass's
per-position states.  Every emitted token is the token the
non-speculative engine would emit, so a source changes only how many
tokens a round commits, never which.

A source is a small object the superstep calls once per round, with
tensor ops on fixed shapes and no read of the device:

  * ``draft_len``                          -- S, the most drafts a round;
  * ``extra_state(batch, max_len, device)`` -- per-slot state the source
    carries in the slot state (e.g. the draft model's decode cache);
  * ``propose(params, st)``  -- (drafts (B, S) int32, n_draft (B,) int32)
    continuing ``st["tok"]`` on every row (the superstep masks the rows
    that are not decoding);
  * ``commit(params, st, tok_blk, valid_eff)`` -- state updates after the
    round committed ``valid_eff[b]`` tokens of ``tok_blk[b]``.

Sources: :class:`NGramDraft` (self-drafting from the request's own
prompt and output), :class:`ModelDraft` (a minGRU / minLSTM draft model
with the target's tokenizer; with the target's own config and weights it
accepts every draft) and :class:`FixedDraft` (a constant token: every
draft rejected at its first position).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


class NGramDraft:
    """Prompt / output n-gram self-drafting.  History is the slot's prompt
    buffer, which the speculative superstep extends with every emitted
    token (``prompt_len + n_out`` tokens).  The proposal: the most recent
    earlier occurrence of the last ``ngram`` tokens, and the up to
    ``draft_len`` tokens that followed it; no match proposes nothing."""

    params = None                 # no draft weights

    def __init__(self, draft_len: int = 4, ngram: int = 2):
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.draft_len = int(draft_len)
        self.ngram = int(ngram)

    def extra_state(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        return {}

    def propose(self, params, st) -> Tuple[torch.Tensor, torch.Tensor]:
        buf = st["prompt"]                            # (B, P) history
        p_cap = buf.shape[1]
        g, s = self.ngram, self.draft_len
        dev = buf.device
        hist = st["prompt_len"] + st["n_out"]         # tokens of history
        # the last g history tokens: the pattern to find again
        sfx_idx = (hist[:, None] - g + torch.arange(g, device=dev)[None]) \
            .clamp(0, p_cap - 1).long()
        suffix = torch.gather(buf, 1, sfx_idx)        # (B, g)
        # the windows buf[p : p + g] for every start p, by g slices
        n_pos = p_cap - g + 1
        match = torch.ones((buf.shape[0], n_pos), dtype=torch.bool,
                           device=dev)
        for j in range(g):
            match = match & (buf[:, j:j + n_pos] == suffix[:, j:j + 1])
        pos = torch.arange(n_pos, device=dev)[None]
        # p <= hist - g - 1: the window ends before the suffix's own
        # occurrence and its continuation buf[p + g] is history
        ok = match & (pos <= (hist - g - 1)[:, None])
        p_star = torch.where(ok, pos, -1).amax(dim=1)  # the most recent
        has = (p_star >= 0) & (hist >= g + 1)
        cont = p_star + g
        d_idx = (cont[:, None] + torch.arange(s, device=dev)[None]) \
            .clamp(0, p_cap - 1).long()
        drafts = torch.gather(buf, 1, d_idx)
        n_draft = torch.where(has, torch.clamp(hist - cont, max=s), 0)
        return drafts.to(torch.int32), n_draft.to(torch.int32)

    def commit(self, params, st, tok_blk, valid_eff) -> Dict[str, Any]:
        return {}


class ModelDraft:
    """A draft model (same tokenizer) proposing greedy continuations.

    ``cfg`` / ``params`` are the draft model's own.  Its decode cache
    rides the slot state (``extra_state``) and ``commit`` keeps it in
    step with the committed stream: one draft ``decode_chunk`` over the
    tokens the target committed, so it never sees a rejected draft.
    ``propose`` looks ahead with S greedy ``decode_step`` calls from that
    cache; each returns new tensors, so the cache in the slot state is
    never written.

    :meth:`bind` binds the draft weights for the kernels once (as
    ``lm.bind_layers``; the engine calls it with the weights on its
    device), so the draft's kernel operands are its own, beside the
    target's.  A call with other params binds for that call alone."""

    def __init__(self, cfg, params=None, draft_len: int = 4):
        if cfg.block_kind != "minrnn":
            raise ValueError(
                f"ModelDraft needs a recurrent-state draft model "
                f"(block_kind='minrnn'), got {cfg.block_kind!r}")
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        self.cfg = cfg
        self.params = params
        self.draft_len = int(draft_len)
        self.layers = None

    def bind(self, params):
        """Hold ``params`` and their kernel binding (``lm.bind_layers``)."""
        from repro_torch.models import lm
        self.params = params
        self.layers = lm.bind_layers(params, self.cfg)

    def _layers(self, params):
        return self.layers if params is self.params else None

    def extra_state(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        from repro_torch.models import lm
        return {"draft_cache": lm.init_cache(self.cfg, batch, max_len,
                                             device)}

    def propose(self, params, st) -> Tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.models import lm
        layers = self._layers(params)
        cache = st["draft_cache"]           # the lookahead's starting point
        tok = st["tok"]
        drafts = []
        for _ in range(self.draft_len):
            logits, cache = lm.decode_step(params, self.cfg, tok, cache,
                                           layers=layers)
            tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            drafts.append(tok)
        n_draft = torch.full(tok.shape, self.draft_len, dtype=torch.int32,
                             device=tok.device)
        return torch.stack(drafts, dim=1), n_draft

    def commit(self, params, st, tok_blk, valid_eff) -> Dict[str, Any]:
        from repro_torch.models import lm
        _, cache = lm.decode_chunk(params, self.cfg, tok_blk, valid_eff,
                                   st["draft_cache"],
                                   layers=self._layers(params))
        return {"draft_cache": cache}


class FixedDraft:
    """A test source proposing a constant token: with a token the target
    never emits, every draft is rejected at its first position -- the
    rollback path under the most stress."""

    params = None

    def __init__(self, token: int, draft_len: int = 4):
        self.token = int(token)
        self.draft_len = int(draft_len)

    def extra_state(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        return {}

    def propose(self, params, st) -> Tuple[torch.Tensor, torch.Tensor]:
        bsz, dev = st["tok"].shape[0], st["tok"].device
        drafts = torch.full((bsz, self.draft_len), self.token,
                            dtype=torch.int32, device=dev)
        return drafts, torch.full((bsz,), self.draft_len, dtype=torch.int32,
                                  device=dev)

    def commit(self, params, st, tok_blk, valid_eff) -> Dict[str, Any]:
        return {}


def make(kind: str, draft_len: int = 4, **kw):
    """``"ngram"`` -> :class:`NGramDraft`."""
    if kind == "ngram":
        return NGramDraft(draft_len=draft_len, **kw)
    raise ValueError(
        f"unknown draft source {kind!r}; pass 'ngram' or a draft-source "
        f"instance (NGramDraft / ModelDraft)")
