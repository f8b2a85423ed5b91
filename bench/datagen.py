"""Token batches for a training cell, from the seed alone.

A vectorised copy of the synthetic language the launcher trains on: an
order-1 Markov chain over the vocabulary with ``branching`` successors a
token (a seeded table), and with probability ``motif_prob`` at each
position a copy of a recent ``motif_len``-token span (in-context
structure).  Every row of every batch is drawn at once, one position at a
time across rows, so a pool of thousands of rows takes milliseconds.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def token_rows(seed: int, n_rows: int, length: int, vocab: int, *,
               branching: int = 4, motif_len: int = 16,
               motif_prob: float = 0.25) -> np.ndarray:
    """``(n_rows, length)`` int64 token ids from ``seed``."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x5EED])
    table = rng.integers(0, vocab, size=(vocab, branching), dtype=np.int64)
    toks = np.empty((n_rows, length), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=n_rows)
    coin = rng.random((n_rows, length))
    pick = rng.integers(0, branching, size=(n_rows, length))
    where = rng.random((n_rows, length))
    left = np.zeros(n_rows, np.int64)       # tokens of a copy still to go
    src = np.zeros(n_rows, np.int64)        # where the copy reads next
    rows = np.arange(n_rows)
    for i in range(1, length):
        start = (left == 0) & (coin[:, i] < motif_prob) & \
            (i + motif_len < length) & (i > motif_len)
        src = np.where(start, (where[:, i] * (i - motif_len)).astype(
            np.int64), src)
        left = np.where(start, motif_len, left)
        copying = left > 0
        chain = table[toks[:, i - 1], pick[:, i]]
        toks[:, i] = np.where(copying, toks[rows, np.minimum(src, i - 1)],
                              chain)
        src = src + copying
        left = left - copying
    return toks


def batch_pool(seed: int, n_batches: int, batch: int, seq_len: int,
               vocab: int, markov: Dict) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` distinct batches ``{"tokens", "labels"}`` (int32,
    ``(batch, seq_len)``, labels the next tokens); no two rows alike."""
    toks = token_rows(seed, n_batches * batch, seq_len + 1, vocab, **markov)
    toks = toks.reshape(n_batches, batch, seq_len + 1)
    return [{"tokens": t[:, :-1].astype(np.int32),
             "labels": t[:, 1:].astype(np.int32)} for t in toks]
