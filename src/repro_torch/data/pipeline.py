"""Deterministic synthetic data pipeline — the port's own numpy copy of
``repro/data/pipeline.py``, batch for batch identical to it for the same
seed, with the reference's resume cursor and the stub frame embeddings of
the encoder-decoder models (:func:`encoder_frames`).

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
from typing import Dict, Iterator, Optional

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


# --------------------------------------------------------------------- #
# Resume cursor
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Cursor:
    """Data-pipeline position persisted in the checkpoint manifest.

    ``step`` is the NEXT unconsumed global batch index: a checkpoint taken
    after consuming batches ``[0, k)`` carries ``step == k``, so a resumed
    run draws batch ``k`` first and never trains a batch twice (nor skips
    one).  ``epoch``/``index`` are the epoch-relative view for finite
    datasets (``steps_per_epoch > 0``); the synthetic stream is endless,
    so there ``epoch == 0`` and ``index == step``."""
    step: int
    epoch: int = 0
    index: int = 0


def cursor_for_step(step: int, steps_per_epoch: int = 0) -> Cursor:
    """Cursor whose next unconsumed batch is global ``step``."""
    step = int(step)
    if steps_per_epoch and steps_per_epoch > 0:
        return Cursor(step=step, epoch=step // steps_per_epoch,
                      index=step % steps_per_epoch)
    return Cursor(step=step, epoch=0, index=step)


def cursor_metadata(cursor: Cursor) -> Dict[str, int]:
    """Manifest-serializable form (plain ints)."""
    return {"step": int(cursor.step), "epoch": int(cursor.epoch),
            "index": int(cursor.index)}


def cursor_from_metadata(meta: Optional[Dict],
                         fallback_step: Optional[int] = None
                         ) -> Optional[Cursor]:
    """Recover the cursor from checkpoint metadata.  Checkpoints without a
    ``"cursor"`` key fall back to ``fallback_step`` (the launcher passes
    ``meta["step"] + 1``); ``None`` when neither is available."""
    cur = (meta or {}).get("cursor")
    if isinstance(cur, dict) and "step" in cur:
        return Cursor(step=int(cur["step"]),
                      epoch=int(cur.get("epoch", 0)),
                      index=int(cur.get("index", cur["step"])))
    if fallback_step is not None:
        return cursor_for_step(fallback_step)
    return None


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


def encoder_frames(model_cfg, global_batch: int, step: int, seed: int = 0
                   ) -> Optional[np.ndarray]:
    """Stub frame embeddings for encoder-decoder models (whisper)."""
    if not model_cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng((seed, step, 31_337))
    fd = model_cfg.frontend_dim or model_cfg.d_model
    return rng.standard_normal(
        (global_batch, model_cfg.encoder.n_positions, fd)).astype("float32")
