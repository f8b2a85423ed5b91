"""Attention: full-sequence (training, prefill) and one-token decode
against a ring-buffer KV cache (port of ``repro/models/attention.py``).

The reference is plain jnp, not a Pallas kernel, so the port is plain
torch in the reference's order: q/k/v projections (with stat capture),
RoPE, scores in float32 from the working-dtype inputs, an additive mask,
a float32 softmax, and the value product.  GQA and sliding windows are
kept, and cross-attention (``kv_source``: the encoder-decoder models'
decoder reads the encoder's output, without RoPE and without a mask).

Decode keeps a ring of ``kv_cache_len`` slots a layer (bounded by the
window on sliding-window layers), the absolute position of each slot in
``slot_pos`` (-1: empty), and writes the new token's k, v and position
at slot ``pos % length``.  The reference writes the slot with a one-hot
``where`` (for GSPMD sharding), which copies the whole cache each token;
the port writes it in place with ``index_copy_`` into the caller's cache
(a layer's view of the stacked cache), with the same result.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models import layers
from repro_torch.models.config import LayerSpec, ModelConfig

NEG_INF = -2.0 ** 30


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
              device) -> Dict:
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q": layers.dense_init(gen, cfg.d_model, h * dh,
                               bias=cfg.use_qkv_bias, **kw),
        "k": layers.dense_init(gen, cfg.d_model, hk * dh,
                               bias=cfg.use_qkv_bias, **kw),
        "v": layers.dense_init(gen, cfg.d_model, hk * dh,
                               bias=cfg.use_qkv_bias, **kw),
        "o": layers.dense_init(gen, h * dh, cfg.d_model,
                               scale=1.0 / math.sqrt(h * dh), **kw),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def _scores(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Scaled, softcapped float32 scores (B, hk, g, S, T) of the queries
    q (B, S, h, dh) against the keys k (B, T, hk, dh)."""
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    scale = cfg.attn_scale or (1.0 / math.sqrt(dh))
    qg = q.reshape(*q.shape[:-2], hk, cfg.n_heads // hk, dh)
    # The reference writes the score einsum as "bshgd,btha->bhgst": the q
    # and k head dims carry different letters, so each is summed on its
    # own (in float32) and the scores are (Σ_d q)·(Σ_d k), not q·k.  The
    # port reproduces that result, in prefill and decode; see ROADMAP
    # queue 3.
    q_sum = (qg * scale).float().sum(dim=-1)                  # (B, S, hk, g)
    k_sum = k.float().sum(dim=-1)                             # (B, T, hk)
    scores = torch.einsum("bshg,bth->bhgst", q_sum, k_sum)
    return layers.softcap(scores, cfg.attn_softcap)


def _attend(scores: torch.Tensor, v: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """float32 softmax over the keys, the value product, the heads merged
    back into x's shape and dtype."""
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.to(x.dtype).reshape(*x.shape[:-1], -1)


def full_seq_attention(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                       spec: LayerSpec, positions: torch.Tensor, *,
                       kv_source: Optional[torch.Tensor] = None,
                       causal: bool = True,
                       stats: Optional[dict] = None,
                       return_kv: bool = False):
    """x: (B, S, D); positions: (B, S) int; ``kv_source`` (B, T, D): the
    encoder output a cross-attention reads its keys and values from (then
    no RoPE and no mask).  Returns (B, S, D), or with ``return_kv`` the
    pair (out, (k, v)): the keys (roped, but for cross-attention) and the
    values, (B, T, hk, dh) in x's dtype, which prefill puts in the
    cache."""
    h, hk = cfg.n_heads, cfg.n_kv_heads
    xs = kv_source if kv_source is not None else x
    q = _split_heads(layers.dense(p["q"], x, stats=stats, name="q"), h)
    k = _split_heads(layers.dense(p["k"], xs, stats=stats, name="k"), hk)
    v = _split_heads(layers.dense(p["v"], xs, stats=stats, name="v"), hk)
    if kv_source is None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    dt = x.dtype
    q, k, v = q.to(dt), k.to(dt), v.to(dt)

    scores = _scores(q, k, cfg)
    if kv_source is None:
        qi = positions[:, None, None, :, None]
        ki = positions[:, None, None, None, :]
        s = x.shape[1]
        mask = torch.ones((1, 1, 1, s, s), dtype=torch.bool,
                          device=x.device)
        if causal:
            mask = mask & (ki <= qi)
        if spec.window is not None:
            mask = mask & (ki > qi - spec.window)
        scores = scores + torch.where(mask, 0.0, NEG_INF).to(scores.dtype)
    y = layers.dense(p["o"], _attend(scores, v, x), stats=stats, name="o")
    return (y, (k, v)) if return_kv else y


# ----------------------------------------------------------------------- #
# KV cache (decode)
# ----------------------------------------------------------------------- #
def kv_cache_len(spec: LayerSpec, seq_len: int) -> int:
    """Ring-buffer length: bounded by the window for SWA layers."""
    if spec.window is not None:
        return min(spec.window, seq_len + 1)
    return seq_len + 1


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  seq_len: int, dtype, device) -> Dict:
    """An empty ring: k, v zeros (B, length, hk, dh), ``slot_pos`` -1."""
    length = kv_cache_len(spec, seq_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # stored absolute position per slot; -1 = empty
        "slot_pos": torch.full((length,), -1, dtype=torch.int32,
                               device=device),
    }


def decode_attention(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     spec: LayerSpec, pos: torch.Tensor, cache: Dict, *,
                     kv_source_cache: Optional[Dict] = None):
    """One-token decode: x (B, 1, D) at position ``pos`` (a 0-d int32
    tensor on x's device) against ``cache`` ``{"k", "v", "slot_pos"}``,
    whose slot ``pos % length`` takes the new token's k, v and position,
    in place.  With ``kv_source_cache`` (whisper's cross-attention: the
    encoder's static k, v) the query reads those, without RoPE or mask,
    and ``cache`` is left as it is.  Returns (out (B, 1, D), cache)."""
    q = _split_heads(layers.dense(p["q"], x), cfg.n_heads)
    bias = None
    if kv_source_cache is not None:
        k, v = kv_source_cache["k"], kv_source_cache["v"]
    else:
        # (B, 1) positions from the device scalar: no host read
        positions = pos.reshape(1, 1).expand(x.shape[0], 1)
        q = layers.rope(q, positions, cfg.rope_theta)
        kn = _split_heads(layers.dense(p["k"], x), cfg.n_kv_heads)
        vn = _split_heads(layers.dense(p["v"], x), cfg.n_kv_heads)
        kn = layers.rope(kn, positions, cfg.rope_theta)
        k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
        slot = (pos % k.shape[1]).reshape(1).long()
        k.index_copy_(1, slot, kn.to(k.dtype))
        v.index_copy_(1, slot, vn.to(v.dtype))
        slot_pos.index_copy_(0, slot, pos.reshape(1).to(slot_pos.dtype))
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if spec.window is not None:
            valid = valid & (slot_pos > pos - spec.window)
        bias = torch.where(valid, 0.0, NEG_INF)

    scores = _scores(q, k, cfg)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return layers.dense(p["o"], _attend(scores, v, x)), cache
