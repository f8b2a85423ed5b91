"""Full-sequence attention (port of ``full_seq_attention`` in
``repro/models/attention.py``).

The reference is plain jnp, not a Pallas kernel, so the port is plain
torch in the reference's order: q/k/v projections (with stat capture),
RoPE, scores in float32 from the working-dtype inputs, an additive mask,
a float32 softmax, and the value product.  GQA and sliding windows are
kept, and cross-attention (``kv_source``: the encoder-decoder models'
decoder reads the encoder's output, without RoPE and without a mask).
The KV-cache decode path arrives with serving.
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


def full_seq_attention(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                       spec: LayerSpec, positions: torch.Tensor, *,
                       kv_source: Optional[torch.Tensor] = None,
                       causal: bool = True,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """x: (B, S, D); positions: (B, S) int; ``kv_source`` (B, T, D): the
    encoder output a cross-attention reads its keys and values from (then
    no RoPE and no mask).  Returns (B, S, D)."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    xs = kv_source if kv_source is not None else x
    q = _split_heads(layers.dense(p["q"], x, stats=stats, name="q"), h)
    k = _split_heads(layers.dense(p["k"], xs, stats=stats, name="k"), hk)
    v = _split_heads(layers.dense(p["v"], xs, stats=stats, name="v"), hk)
    if kv_source is None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    dt = x.dtype
    q, k, v = q.to(dt), k.to(dt), v.to(dt)

    scale = cfg.attn_scale or (1.0 / math.sqrt(dh))
    qg = q.reshape(*q.shape[:-2], hk, g, dh)
    # The reference writes the score einsum as "bshgd,btha->bhgst": the q
    # and k head dims carry different letters, so each is summed on its
    # own (in float32) and the scores are (Σ_d q)·(Σ_d k), not q·k.  The
    # port reproduces that result; see ROADMAP queue 3.
    q_sum = (qg * scale).float().sum(dim=-1)                  # (B, S, hk, g)
    k_sum = k.float().sum(dim=-1)                             # (B, T, hk)
    scores = torch.einsum("bshg,bth->bhgst", q_sum, k_sum)
    scores = layers.softcap(scores, cfg.attn_softcap)

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
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    out = out.to(dt).reshape(*x.shape[:-1], h * dh)
    return layers.dense(p["o"], out, stats=stats, name="o")
