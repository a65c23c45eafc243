"""Synthetic task generators for the paper's benchmarks, copied from
``repro.data.synthetic`` (numpy only; the same seeds give the same arrays
bit for bit).

All generators are pure functions of (seed, step) -- the training data
pipeline is stateless, so checkpoint-restart needs no iterator state.

Tasks:
  * selective_copy      -- Mamba paper (Gu & Dao 2024) / paper Tables 1-2
  * Chomsky-hierarchy   -- Deletang et al. 2023 + xLSTM extras / Table 5:
    even_pairs, majority, majority_count, cycle_nav, bucket_sort,
    missing_duplicate
  * listops             -- LRA-style nested prefix expressions / Table 6
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

IGNORE = -1


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed * 1_000_003 + step))


# ---------------------------------------------------------------------------
# Selective copy (paper §4.1/4.2): vocab 16, n_data tokens among noise;
# the model must reproduce the data tokens, in order, at the end.
# Token map: 0 noise, 1..13 data values, 14 sep. vocab_size = 16.
# ---------------------------------------------------------------------------

def selective_copy_batch(seed: int, step: int, batch: int,
                         seq_len: int = 4096, n_data: int = 16,
                         vocab: int = 16) -> Dict[str, np.ndarray]:
    """Returns tokens (B, T) and labels (B, T) where labels[p] is the
    next-token target for tokens[p]: IGNORE everywhere except the answer
    span (the model must emit the data tokens, in order, after the sep)."""
    rng = _rng(seed, step)
    n_values = vocab - 3
    sep = vocab - 2
    total = seq_len + 1 + n_data           # input + sep + answer slots
    tokens = np.zeros((batch, total), np.int32)
    targets = np.full((batch, total), IGNORE, np.int32)
    values = rng.integers(1, n_values + 1, size=(batch, n_data))
    for b in range(batch):
        pos = rng.choice(seq_len, size=n_data, replace=False)
        pos.sort()
        tokens[b, pos] = values[b]
    tokens[:, seq_len] = sep
    tokens[:, seq_len + 1:] = values       # teacher forcing
    # target for position p is tokens[p+1]: answer starts after the sep
    targets[:, seq_len:seq_len + n_data] = values
    return {"tokens": tokens[:, :-1], "labels": targets[:, :-1]}


def selective_copy_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    pred = logits.argmax(-1)
    mask = labels >= 0
    return float((pred[mask] == labels[mask]).mean())


# ---------------------------------------------------------------------------
# Chomsky-hierarchy classification tasks.  Each returns
# {"tokens": (B, T), "label": (B,)} with n_classes in CLS_CLASSES.
# ---------------------------------------------------------------------------

CLS_VOCAB = 16            # shared token space for the suite
PAD = 0


def even_pairs(seed, step, batch, min_len=2, max_len=40):
    """Regular: is the number of 'ab'/'ba' transitions even (first==last)?"""
    rng = _rng(seed, step)
    tokens = np.zeros((batch, max_len), np.int32)
    label = np.zeros((batch,), np.int32)
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, 3, size=n)       # tokens {1, 2}
        tokens[b, :n] = s
        label[b] = int(s[0] == s[-1])
    return {"tokens": tokens, "label": label, "n_classes": 2}


def majority(seed, step, batch, min_len=2, max_len=40, n_sym=4):
    rng = _rng(seed, step)
    tokens = np.zeros((batch, max_len), np.int32)
    label = np.zeros((batch,), np.int32)
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, n_sym + 1, size=n)
        tokens[b, :n] = s
        counts = np.bincount(s, minlength=n_sym + 1)
        label[b] = int(counts[1:].argmax())   # 0..n_sym-1
    return {"tokens": tokens, "label": label, "n_classes": n_sym}


def majority_count(seed, step, batch, min_len=2, max_len=40, n_sym=2):
    """Count of the majority symbol (class = count, up to max_len)."""
    rng = _rng(seed, step)
    tokens = np.zeros((batch, max_len), np.int32)
    label = np.zeros((batch,), np.int32)
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, n_sym + 1, size=n)
        tokens[b, :n] = s
        counts = np.bincount(s, minlength=n_sym + 1)
        label[b] = int(counts[1:].max())
    return {"tokens": tokens, "label": label, "n_classes": max_len + 1}


def cycle_nav(seed, step, batch, min_len=2, max_len=40, n_states=5):
    """Moves {+1, -1, 0} on a cycle of 5; classify the final position."""
    rng = _rng(seed, step)
    tokens = np.zeros((batch, max_len), np.int32)
    label = np.zeros((batch,), np.int32)
    moves = np.array([1, -1, 0])
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, 4, size=n)        # tokens {1,2,3}
        tokens[b, :n] = s
        label[b] = int(moves[s - 1].sum() % n_states)
    return {"tokens": tokens, "label": label, "n_classes": n_states}


def missing_duplicate(seed, step, batch, min_len=2, max_len=20):
    """Sequence s + separator + s-with-a-hole; classify the missing token."""
    rng = _rng(seed, step)
    total = 2 * max_len + 1
    tokens = np.zeros((batch, total), np.int32)
    label = np.zeros((batch,), np.int32)
    hole, sep = 3, 4                          # symbols {1,2}, hole=3, sep=4
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, 3, size=n)
        miss = int(rng.integers(0, n))
        s2 = s.copy()
        s2[miss] = hole
        tokens[b, :n] = s
        tokens[b, n] = sep
        tokens[b, n + 1:2 * n + 1] = s2
        label[b] = int(s[miss] - 1)
    return {"tokens": tokens, "label": label, "n_classes": 2}


def bucket_sort(seed, step, batch, min_len=2, max_len=40, n_sym=5):
    """Sequence-to-sequence: emit the tokens in sorted order (LM format)."""
    rng = _rng(seed, step)
    sep = n_sym + 1
    total = 2 * max_len + 1
    tokens = np.zeros((batch, total), np.int32)
    targets = np.full((batch, total), IGNORE, np.int32)
    for b in range(batch):
        n = int(rng.integers(min_len, max_len + 1))
        s = rng.integers(1, n_sym + 1, size=n)
        srt = np.sort(s)
        tokens[b, :n] = s
        tokens[b, n] = sep
        tokens[b, n + 1:n + 1 + n] = srt
        targets[b, n:n + n] = srt
    return {"tokens": tokens[:, :-1], "labels": targets[:, 1:],
            "vocab": n_sym + 2}


def listops(seed, step, batch, max_len=128, max_depth=4):
    """Nested prefix expressions over digits: MAX MIN MED SUM_MOD.
    Tokens: 0 pad, 1-10 digits 0-9, 11 [MAX, 12 [MIN, 13 [MED, 14 [SM, 15 ]."""
    rng = _rng(seed, step)
    OPS = [11, 12, 13, 14]

    def gen(depth):
        if depth == 0 or rng.random() < 0.4:
            d = int(rng.integers(0, 10))
            return [d + 1], d
        op = int(rng.integers(0, 4))
        n_args = int(rng.integers(2, 4))
        toks, vals = [OPS[op]], []
        for _ in range(n_args):
            t, v = gen(depth - 1)
            toks.extend(t)
            vals.append(v)
        toks.append(15)
        if op == 0:
            out = max(vals)
        elif op == 1:
            out = min(vals)
        elif op == 2:
            out = sorted(vals)[len(vals) // 2]
        else:
            out = sum(vals) % 10
        return toks, out

    tokens = np.zeros((batch, max_len), np.int32)
    label = np.zeros((batch,), np.int32)
    for b in range(batch):
        while True:
            toks, val = gen(max_depth)
            if len(toks) <= max_len:
                break
        tokens[b, :len(toks)] = toks
        label[b] = val
    return {"tokens": tokens, "label": label, "n_classes": 10}


CHOMSKY_TASKS = {
    "even_pairs": even_pairs,
    "majority": majority,
    "majority_count": majority_count,
    "cycle_nav": cycle_nav,
    "missing_duplicate": missing_duplicate,
}
