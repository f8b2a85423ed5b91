"""Deterministic synthetic data pipeline — the port's own numpy copy of
``repro/data/pipeline.py``, batch for batch identical to it for the same
seed (the resume cursor and encoder frames arrive with checkpointing and
the encoder-decoder models).

The original corpora (Wikipedia/BookCorpus, GLUE, ImageNet) are unavailable
offline (DESIGN.md §7), so the pipeline generates *learnable* token streams:
an order-1 Markov chain over the vocabulary with sparse, seeded transition
structure plus repeated copy-motifs.  Losses drop well below the unigram
entropy, which is what the optimizer-convergence experiments need.

Properties a real pipeline needs and this one has:
* deterministic per (seed, step, shard) — restart-safe, resumable;
* shard-aware: each data-parallel worker draws a disjoint slice;
* document packing into fixed-length sequences with next-token labels;
* zero-copy host staging via numpy, device put handled by the caller/pjit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # out-degree of the Markov chain
    motif_len: int = 16         # copyable motif length
    motif_prob: float = 0.25
    n_shards: int = 1
    shard_id: int = 0
    frontend_len: int = 0       # multimodal prefix (stub embeddings)
    frontend_dim: int = 0
    embed_dtype: str = "float32"


def _chain(cfg: SyntheticLMConfig) -> np.ndarray:
    """Sparse transition table: vocab x branching successor ids."""
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branching), dtype=np.int64)


def _sample_doc(rng, table, cfg: SyntheticLMConfig, length: int) -> np.ndarray:
    toks = np.empty(length, np.int64)
    toks[0] = rng.integers(cfg.vocab_size)
    i = 1
    while i < length:
        if rng.random() < cfg.motif_prob and i + cfg.motif_len < length \
                and i > cfg.motif_len:
            # copy motif: repeat a recent span (gives in-context structure)
            start = rng.integers(0, i - cfg.motif_len)
            span = toks[start:start + cfg.motif_len]
            n = min(cfg.motif_len, length - i)
            toks[i:i + n] = span[:n]
            i += n
        else:
            toks[i] = table[toks[i - 1], rng.integers(cfg.branching)]
            i += 1
    return toks


def make_batch(cfg: SyntheticLMConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for ``step`` on this shard (deterministic)."""
    assert cfg.global_batch % cfg.n_shards == 0
    local = cfg.global_batch // cfg.n_shards
    table = _chain(cfg)
    n_text = cfg.seq_len - cfg.frontend_len
    toks = np.empty((local, n_text + 1), np.int64)
    for r in range(local):
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard_id * local + r))
        toks[r] = _sample_doc(rng, table, cfg, n_text + 1)
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if cfg.frontend_len:
        rng = np.random.default_rng((cfg.seed, step, 7_777, cfg.shard_id))
        batch["frontend_embeds"] = rng.standard_normal(
            (local, cfg.frontend_len, cfg.frontend_dim),
        ).astype(cfg.embed_dtype)
    return batch


def synthetic_batches(cfg: SyntheticLMConfig, n_steps: int,
                      start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    for s in range(start_step, start_step + n_steps):
        yield make_batch(cfg, s)


def make_dataset(model_cfg, *, global_batch: int, seq_len: int, seed: int = 0,
                 n_shards: int = 1, shard_id: int = 0) -> SyntheticLMConfig:
    """Dataset config matched to a ModelConfig (handles multimodal prefix)."""
    frontend_len = 0
    frontend_dim = 0
    if model_cfg.frontend != "none":
        if model_cfg.is_encoder_decoder:
            frontend_len = 0          # encoder frames added separately
        else:
            frontend_len = model_cfg.frontend_len
        frontend_dim = model_cfg.frontend_dim or model_cfg.d_model
    cfg = SyntheticLMConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        n_shards=n_shards,
        shard_id=shard_id,
        frontend_len=frontend_len,
        frontend_dim=frontend_dim,
    )
    if model_cfg.is_encoder_decoder:
        cfg = dataclasses.replace(
            cfg, frontend_len=0)
    return cfg
