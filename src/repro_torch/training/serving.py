"""Serving: prefill and single-token decode steps (port of
``repro/training/serving.py``).

* ``prefill``: the full forward over the prompt, building the KV ring
  buffers and the recurrent states (``models/model.py`` ``forward(
  build_cache=True)``).
* ``serve_step``: one new token against that cache.  Sliding-window
  layers keep rings bounded by the window; RWKV and Mamba layers carry
  O(1) state.

Everything runs under ``torch.inference_mode()``.  A decode step updates
the cache it is given in place (the ring slot of each layer, the
recurrent states, ``pos``) and reads nothing back to the host: the greedy
token stays on the device, ready to be the next step's input.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, cache_extra: int = 1) -> Callable:
    """``prefill(params, batch) -> (logits (B, 1, V) of the last position,
    cache)``; the cache has room for ``cache_extra`` more tokens."""
    @torch.inference_mode()
    def prefill(params, batch: Dict):
        logits, aux = model_lib.forward(params, cfg, batch,
                                        collect_stats=False,
                                        build_cache=True,
                                        cache_extra=cache_extra)
        # a copy: a view would keep the (B, S, V) logits alive
        return logits[:, -1:].clone(), aux["cache"]
    return prefill


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.inference_mode()
    def serve_step(params, cache: Dict, tokens: torch.Tensor):
        """tokens: (B, 1), the most recent token.  Returns (next_token
        (B, 1) int32, logits (B, 1, V), cache): the cache passed in,
        updated in place, is the one returned."""
        logits, cache = model_lib.decode_step(params, cfg, tokens, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache
    return serve_step


def decode_batch_shapes(cfg: ModelConfig, batch: int, seq_len: int
                        ) -> Tuple[torch.Tensor, Dict]:
    """(tokens, cache) of the decode shapes as ``meta`` tensors: shapes and
    dtypes, no memory (the reference's ``ShapeDtypeStruct`` /
    ``eval_shape``)."""
    meta = torch.device("meta")
    tokens = torch.empty((batch, 1), dtype=torch.int32, device=meta)
    return tokens, model_lib.init_decode_cache(cfg, batch, seq_len,
                                               device=meta)


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             *, cache_extra: Optional[int] = None) -> torch.Tensor:
    """Greedy generation of ``n_tokens`` after ``prompt`` (B, S) tokens:
    (B, n_tokens) int32 on the prompt's device."""
    prefill = make_prefill_step(
        cfg, cache_extra=n_tokens if cache_extra is None else cache_extra)
    step = make_serve_step(cfg)
    logits, cache = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [tok]
    for _ in range(n_tokens - 1):
        tok, _, cache = step(params, cache, tok)
        outs.append(tok)
    return torch.cat(outs, dim=1)
