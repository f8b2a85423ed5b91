"""Primitive layers: dense (with MKOR stat capture), norms, embeddings, RoPE
(port of ``repro/models/layers.py``).

MKOR stat capture works as in the reference:

* ``ā = E[a]`` — the token-mean input of each dense layer — is recorded in
  the forward pass into a ``stats`` dict (detached: stats are not part of
  the graph).
* ``ḡ = E[g]`` rides the backward pass through a zero ``probe`` parameter
  added to every dense output, ``y = x @ W + probe``.  For a mean-reduced
  loss, ``dL/dprobe = Σ_t dL/dy_t = ḡ`` exactly, so the probe's gradient
  *is* the statistic.  Probes stay zero (the optimizer zeroes their
  updates).

Every dense param dict carries ``{"w", "probe"[, "b"]}``.  Initialisers
draw from an explicit ``torch.Generator``; they do not reproduce JAX's
random numbers (tests carry JAX weights across with ``interop``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


# ----------------------------------------------------------------------- #
# Dense
# ----------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype: torch.dtype, device, scale: Optional[float] = None,
               bias: bool = False) -> Params:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p: Params = {
        "w": (_randn(gen, (d_in, d_out), device) * scale).to(dtype),
        "probe": torch.zeros((d_out,), dtype=torch.float32, device=device),
    }
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor, *, stats: Optional[dict] = None,
          name: str = "") -> torch.Tensor:
    """y = x @ W (+ b) + probe, recording E[a] into ``stats[name]``."""
    if stats is not None:
        flat = x.detach().reshape(-1, x.shape[-1])
        stats[name] = {"a": flat.float().mean(dim=0)}
    w = p["w"]
    # jnp.einsum promotes mixed operands (float32 frames into a bf16
    # frontend projection) to the wider type; torch.matmul refuses them
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if "b" in p:
        y = y + p["b"]
    return y + p["probe"].to(y.dtype)


def grouped_dense(p: Params, x: torch.Tensor, *,
                  stats: Optional[dict] = None, name: str = "",
                  per_expert_stats: bool = False) -> torch.Tensor:
    """Expert-parallel dense: x (E, C, d_in), W (E, d_in, d_out).

    With shared factors (default) E[a] is the mean over all dispatched rows
    (DESIGN.md §4); with ``per_expert_stats`` a per-expert (E, d_in) mean.
    """
    if stats is not None:
        xf = x.detach().float()
        stats[name] = {"a": xf.mean(dim=1) if per_expert_stats
                       else xf.reshape(-1, x.shape[-1]).mean(dim=0)}
    y = torch.bmm(x, p["w"])
    if "b" in p:
        y = y + p["b"][:, None, :]
    return y + p["probe"].to(y.dtype)


def grouped_dense_init(gen: torch.Generator, n_experts: int, d_in: int,
                       d_out: int, *, dtype, device,
                       per_expert_probe: bool = False) -> Params:
    w = _randn(gen, (n_experts, d_in, d_out), device)
    probe_shape = (n_experts, 1, d_out) if per_expert_probe else (d_out,)
    return {"w": (w / math.sqrt(d_in)).to(dtype),
            "probe": torch.zeros(probe_shape, dtype=torch.float32,
                                 device=device)}


# ----------------------------------------------------------------------- #
# Norms
# ----------------------------------------------------------------------- #
def norm_init(d: int, kind: str = "rmsnorm", *, device) -> Params:
    p: Params = {"scale": torch.ones((d,), dtype=torch.float32,
                                     device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, *, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in float32, cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm (RWKV-6 wkv output): over the last dim, in
    float32, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


# ----------------------------------------------------------------------- #
# Embedding
# ----------------------------------------------------------------------- #
def embed_init(gen: torch.Generator, vocab: int, d: int, *, dtype,
               device) -> Params:
    return {"table": (_randn(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["table"].t())


# ----------------------------------------------------------------------- #
# Rotary position embeddings
# ----------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    # a Python-float base: a device tensor built from a host scalar would
    # cost a host-to-device copy, which synchronises the stream
    freq = theta ** (-idx / half)
    ang = positions[..., None].float() * freq                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- #
# Activations / MLP
# ----------------------------------------------------------------------- #
def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind}")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, dtype,
             device, gated: bool = True) -> Params:
    p = {
        "in": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "out": dense_init(gen, d_ff, d_model, dtype=dtype, device=device,
                          scale=1.0 / math.sqrt(d_ff)),
    }
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
    return p


def mlp(p: Params, x: torch.Tensor, *, act: str = "silu",
        stats: Optional[dict] = None, name: str = "") -> torch.Tensor:
    sub = {} if stats is not None else None
    h = dense(p["in"], x, stats=sub, name="in")
    if "gate" in p:
        g = dense(p["gate"], x, stats=sub, name="gate")
        h = activation(g, act) * h
    else:
        h = activation(h, act)
    y = dense(p["out"], h, stats=sub, name="out")
    if stats is not None:
        stats[name] = sub
    return y


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
