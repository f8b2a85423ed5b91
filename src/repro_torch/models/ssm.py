"""Attention-free sequence mixers: RWKV-6 ("Finch") and Mamba (for
Jamba), full-sequence (training, prefill) and one-token decode (port of
``repro/models/ssm.py``).

RWKV-6 (arXiv:2404.05892): token shift with data-dependent ("ddlerp")
mixing through a low-rank MLP, per-channel data-dependent decay
``w_t = exp(-exp(w0 + tanh(x W1) W2))``, a per-head wkv state (N x N),
the bonus ``u``, a group norm, and a relu² channel mix.

Mamba (the selective SSM of Jamba, arXiv:2403.19887): in-projection,
causal depthwise conv, data-dependent (dt, B, C), the discretised scan
and the gated out-projection.

The reference runs each recurrence as a ``lax.scan`` over time; the port
runs it as a loop over the time steps on tensors, in float32 and in the
reference's order of operations.  The projections (r/k/v/g/o, the
channel mix, in/x/dt/out) are ordinary dense layers and get MKOR's
second-order preconditioning; the recurrence parameters (``maa*``,
``decay*``, ``bonus``, ``ln_x_*``, ``conv_*``, ``A_log``, ``D``) are plain
tensors that take the first-order update (DESIGN.md §4).

The full-sequence paths also return the final state that decode carries:
RWKV-6's wkv state and last token (``{"wkv", "x_last"}``; the channel
mix's last token beside the output), Mamba's scan state and the conv's
last ``d_conv - 1`` inputs (``{"h", "conv"}``).  The decode steps
(:func:`rwkv_time_mix_decode`, :func:`mamba_decode`) advance that state
by one token, O(1) in the sequence length.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

# ----------------------------------------------------------------------- #
# RWKV-6
# ----------------------------------------------------------------------- #
RWKV_LORA_MIX = 32
RWKV_LORA_DECAY = 64


def _uniform(gen: torch.Generator, shape, device,
             s: float = 1e-2) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * s) - s


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
              device) -> Dict:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    kw = dict(dtype=dtype, device=device)
    return {
        "maa_x": _uniform(gen, (d,), device),
        "maa": _uniform(gen, (5, d), device),          # w,k,v,r,g base mixes
        "maa_w1": _uniform(gen, (d, 5 * RWKV_LORA_MIX), device),
        "maa_w2": _uniform(gen, (5, RWKV_LORA_MIX, d), device),
        "decay_w0": torch.full((d,), -6.0, device=device),
        "decay_w1": _uniform(gen, (d, RWKV_LORA_DECAY), device),
        "decay_w2": _uniform(gen, (RWKV_LORA_DECAY, d), device),
        "bonus": _uniform(gen, (h, n), device),        # time_faaaa
        "r": layers.dense_init(gen, d, d, **kw),
        "k": layers.dense_init(gen, d, d, **kw),
        "v": layers.dense_init(gen, d, d, **kw),
        "g": layers.dense_init(gen, d, d, **kw),
        "o": layers.dense_init(gen, d, d, scale=1.0 / math.sqrt(d), **kw),
        "ln_x_scale": torch.ones((n,), device=device),
        "ln_x_bias": torch.zeros((n,), device=device),
    }


def rwkv_cm_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
                 device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "maa_k": _uniform(gen, (d,), device),
        "maa_r": _uniform(gen, (d,), device),
        "key": layers.dense_init(gen, d, f, **kw),
        "value": layers.dense_init(gen, f, d, scale=1.0 / math.sqrt(f), **kw),
        "recept": layers.dense_init(gen, d, d, **kw),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's x (zeros before the first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rwkv_projections(p, x, x_prev, cfg: ModelConfig, stats):
    """Data-dependent token-shift mixing + r/k/v/g/w projections.

    x, x_prev: (B, S, d).  Returns r, k, v heads (B, S, H, N), g (B, S, d)
    and the decay w heads (B, S, H, N)."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    xx = x_prev - x
    xxx = x + xx * p["maa_x"]
    router = torch.tanh(xxx.float() @ p["maa_w1"])
    router = router.reshape(*x.shape[:-1], 5, RWKV_LORA_MIX)
    mix = torch.einsum("...fi,fid->...fd", router, p["maa_w2"])
    mix = mix + p["maa"]                                 # (..., 5, d)
    xw, xk, xv, xr, xg = [x + xx * mix[..., i, :].to(x.dtype)
                          for i in range(5)]
    r = layers.dense(p["r"], xr, stats=stats, name="r")
    k = layers.dense(p["k"], xk, stats=stats, name="k")
    v = layers.dense(p["v"], xv, stats=stats, name="v")
    g = F.silu(layers.dense(p["g"], xg, stats=stats, name="g"))
    dec = p["decay_w0"] + torch.tanh(xw.float() @ p["decay_w1"]) \
        @ p["decay_w2"]
    w = torch.exp(-torch.exp(dec))                       # (B, S, d) in (0, 1)

    def hd(t):
        return t.reshape(*t.shape[:-1], h, n)
    return hd(r), hd(k), hd(v), g, hd(w)


def _wkv_step(state, r, k, v, w, bonus):
    """state (B, H, N, N); r, k, v, w (B, H, N).
    y_j = Σ_i r_i (S_ij + u_i k_i v_j)."""
    kv = torch.einsum("bhi,bhj->bhij", k, v)
    y = torch.einsum("bhi,bhij->bhj", r, state + bonus[..., None] * kv)
    return state * w[..., None] + kv, y


def rwkv_time_mix(p, x, cfg: ModelConfig, *,
                  stats: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence RWKV-6 time mixing.  Returns (y, final_state_dict)."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    r, k, v, g, w = _rwkv_projections(p, x, _token_shift(x), cfg, stats)
    state = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    ys = []
    for t in range(s):
        state, y_t = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t],
                               p["bonus"])
        ys.append(y_t)
    y = torch.stack(ys, dim=1)                           # (B, S, H, N)
    y = layers.group_norm(y, p["ln_x_scale"], p["ln_x_bias"])
    y = y.reshape(b, s, d).to(x.dtype) * g
    out = layers.dense(p["o"], y, stats=stats, name="o")
    return out, {"wkv": state, "x_last": x[:, -1]}


def rwkv_time_mix_decode(p, x, cfg: ModelConfig, cache: Dict
                         ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); cache: ``{"wkv": (B, H, N, N),
    "x_last": (B, d)}``.  Returns (y, the new ``{"wkv", "x_last"}``)."""
    b, _, d = x.shape
    r, k, v, g, w = _rwkv_projections(p, x, cache["x_last"][:, None, :],
                                      cfg, None)
    state, y = _wkv_step(cache["wkv"], r[:, 0].float(), k[:, 0].float(),
                         v[:, 0].float(), w[:, 0].float(), p["bonus"])
    y = layers.group_norm(y[:, None], p["ln_x_scale"], p["ln_x_bias"])
    y = y.reshape(b, 1, d).to(x.dtype) * g
    return layers.dense(p["o"], y), {"wkv": state, "x_last": x[:, 0]}


def rwkv_channel_mix(p, x, *, x_prev: Optional[torch.Tensor] = None,
                     stats: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """relu² channel mix with token shift (``x_prev``: the previous
    tokens' x, (B, S, d); by default x shifted by one, zeros first).
    Returns (y, x_last)."""
    if x_prev is None:
        x_prev = _token_shift(x)
    xx = x_prev - x
    xk = x + xx * p["maa_k"].to(x.dtype)
    xr = x + xx * p["maa_r"].to(x.dtype)
    kk = layers.activation(layers.dense(p["key"], xk, stats=stats,
                                        name="key"), "relu2")
    kv = layers.dense(p["value"], kk, stats=stats, name="value")
    rr = torch.sigmoid(layers.dense(p["recept"], xr, stats=stats,
                                    name="recept"))
    return rr * kv, x[:, -1]


# ----------------------------------------------------------------------- #
# Mamba (selective SSM)
# ----------------------------------------------------------------------- #
def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
               device) -> Dict:
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dt_rank = _dt_rank(cfg)
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                     device=device).expand(di, mc.d_state)
    return {
        "in": layers.dense_init(gen, d, 2 * di, **kw),
        "conv_w": torch.randn((mc.d_conv, di), generator=gen, device=device,
                              dtype=torch.float32)
        * (1.0 / math.sqrt(mc.d_conv)),
        "conv_b": torch.zeros((di,), device=device),
        "x_proj": layers.dense_init(gen, di, dt_rank + 2 * mc.d_state, **kw),
        "dt": layers.dense_init(gen, dt_rank, di, bias=True, **kw),
        "A_log": torch.log(a).contiguous(),
        "D": torch.ones((di,), device=device),
        "out": layers.dense_init(gen, di, d, scale=1.0 / math.sqrt(di), **kw),
    }


def _mamba_ssm_inputs(p, xc, cfg: ModelConfig, stats):
    """The data-dependent SSM parameters.  xc: post-conv (B, S, di).
    Returns dA, dB·x (B, S, di, n) and C (B, S, n), float32."""
    mc = cfg.mamba
    dt_rank = _dt_rank(cfg)
    xdb = layers.dense(p["x_proj"], xc, stats=stats, name="x_proj")
    dt, bmat, cmat = torch.split(xdb, [dt_rank, mc.d_state, mc.d_state],
                                 dim=-1)
    dt = F.softplus(layers.dense(p["dt"], dt, stats=stats,
                                 name="dt").float())
    a = -torch.exp(p["A_log"])                            # (di, n)
    da = torch.exp(dt[..., None] * a)                     # (B, S, di, n)
    dbx = (dt * xc.float())[..., None] * bmat.float()[..., None, :]
    return da, dbx, cmat.float()


def _causal_conv(p, x, cfg: ModelConfig, *,
                 buf: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, di), then SiLU.  ``buf`` (B,
    d_conv - 1, di): the inputs before x (zeros by default).  Returns
    (out, the last d_conv - 1 inputs: the next call's ``buf``)."""
    mc = cfg.mamba
    if buf is None:
        pad = torch.zeros((x.shape[0], mc.d_conv - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = buf.to(x.dtype)
    xe = torch.cat([pad, x], dim=1)
    out = xe[:, 0:x.shape[1]] * p["conv_w"][0].to(x.dtype)
    for i in range(1, mc.d_conv):
        out = out + xe[:, i:i + x.shape[1]] * p["conv_w"][i].to(x.dtype)
    new_buf = xe[:, xe.shape[1] - (mc.d_conv - 1):] if mc.d_conv > 1 \
        else pad
    return F.silu(out + p["conv_b"].to(x.dtype)), new_buf


def mamba_apply(p, x, cfg: ModelConfig, *, stats: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence selective scan.  Returns (y, final_state_dict)."""
    mc = cfg.mamba
    b, s, _ = x.shape
    di = mc.expand * cfg.d_model
    xz = layers.dense(p["in"], x, stats=stats, name="in")
    x1, z = torch.split(xz, di, dim=-1)
    xc, conv_buf = _causal_conv(p, x1, cfg)
    da, dbx, cmat = _mamba_ssm_inputs(p, xc, cfg, stats)
    hs = torch.zeros((b, di, mc.d_state), dtype=torch.float32,
                     device=x.device)
    ys = []
    for t in range(s):
        hs = da[:, t] * hs + dbx[:, t]                    # (B, di, n)
        ys.append(torch.einsum("bdn,bn->bd", hs, cmat[:, t]))
    y = torch.stack(ys, dim=1)                            # (B, S, di)
    y = y + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = layers.dense(p["out"], y, stats=stats, name="out")
    return out, {"h": hs, "conv": conv_buf}


def mamba_decode(p, x, cfg: ModelConfig, cache: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, d); cache: ``{"h": (B, di, n), "conv":
    (B, d_conv - 1, di)}``.  Returns (y, the new ``{"h", "conv"}``)."""
    di = cfg.mamba.expand * cfg.d_model
    x1, z = torch.split(layers.dense(p["in"], x), di, dim=-1)
    xc, conv_buf = _causal_conv(p, x1, cfg, buf=cache["conv"])
    da, dbx, cmat = _mamba_ssm_inputs(p, xc, cfg, None)
    hs = da[:, 0] * cache["h"] + dbx[:, 0]
    y = torch.einsum("bdn,bn->bd", hs, cmat[:, 0])[:, None]
    y = y + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return layers.dense(p["out"], y), {"h": hs, "conv": conv_buf}
