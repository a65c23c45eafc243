"""Synthetic task data: the selective-copy task (Mamba paper, Gu & Dao
2024; the paper's Tables 1-2), copied from ``repro.data.synthetic``.

A pure function of (seed, step), so the training data pipeline is
stateless and checkpoint-restart needs no iterator state.  The other
tasks of the reference module wait for their heads (ROADMAP.md queue 1,
item 5).
"""

from __future__ import annotations

from typing import Dict

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
