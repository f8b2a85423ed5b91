"""Mixture-of-Experts: top-k routed MLP with capacity-based dispatch (port
of ``repro/models/moe.py``).

Routing is computed per batch row, as in the reference: an fp32 router,
``top_k`` over its softmax and renormalisation, the Switch load-balance
aux loss (plus the optional z-loss), then a capacity dispatch in which
each (token, choice) takes the next free slot of its expert, and choices
past an expert's capacity go to a trash slot and are dropped.  The
experts run as grouped GEMMs over ``(E, B·C, d)``; the combine weights
each expert output by its renormalised gate and sums a token's choices;
the shared experts (qwen2-moe) add a dense gated MLP of the whole input.

The reference writes the dispatch as a gather ``xp[rows, dis_idx]`` and
the combine as a scatter-add ``out.at[rows, dis_idx].add(yd)``.  On CUDA
both scatter-adds (the combine, and the gather's backward, where a token
dispatched to k experts gathers k gradients) would be atomic adds in an
order that changes from run to run.  The port adds in a fixed order
instead, with the same sums:

* the dispatch is :class:`_Dispatch`, a gather whose backward is a
  gather over the inverse slot map: a token's gradient is the sum of its
  slots' gradients, over its choices in slot order;
* the combine gathers each (token, choice)'s expert output from its slot
  (the gather's backward writes each slot once; dropped choices read a
  zero trash row) and sums a token's choices in slot order.

The reference's scatter adds a token's slots in slot order as well, so
the sums agree with it to the rounding of the same additions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, MoEConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> Dict:
    m = cfg.moe
    pep = m.per_expert_factors
    kw = dict(dtype=dtype, device=device, per_expert_probe=pep)
    p = {
        "router": layers.dense_init(gen, cfg.d_model, m.n_experts,
                                    dtype=torch.float32, device=device,
                                    scale=0.02),
        "in": layers.grouped_dense_init(gen, m.n_experts, cfg.d_model,
                                        m.expert_d_ff, **kw),
        "gate": layers.grouped_dense_init(gen, m.n_experts, cfg.d_model,
                                          m.expert_d_ff, **kw),
        "out": layers.grouped_dense_init(gen, m.n_experts, m.expert_d_ff,
                                         cfg.d_model, **kw),
    }
    if m.n_shared_experts > 0:
        shared_ff = m.shared_d_ff or m.n_shared_experts * m.expert_d_ff
        p["shared"] = layers.mlp_init(gen, cfg.d_model, shared_ff,
                                      dtype=dtype, device=device, gated=True)
    return p


def capacity(m: MoEConfig, seq: int) -> int:
    return max(1, int(math.ceil(seq * m.top_k / m.n_experts
                                * m.capacity_factor)))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over a new last dim, by comparison (no host read of the
    indices, which ``F.one_hot``'s range check can make)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _slot_sum(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """rows (B, S, k, d) summed over k in the order ``order`` (B, S, k)
    gives, one addition after another (the reference's scatter order)."""
    ranked = torch.gather(rows, 2, order[..., None].expand(rows.shape))
    out = ranked[:, :, 0]
    for j in range(1, rows.shape[2]):
        out = out + ranked[:, :, j]
    return out


class _Dispatch(torch.autograd.Function):
    """``xd[b, slot] = xp[b, dis_idx[b, slot]]`` (xp: x with a zero row at
    index S), whose backward sums each token's slot gradients over its
    choices in slot order (a gather over ``dest``, no scatter-add)."""

    @staticmethod
    def forward(ctx, x, dis_idx, dest, order):
        b, s, d = x.shape
        xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        ctx.save_for_backward(dest, order)
        return torch.gather(xp, 1, dis_idx[..., None].expand(-1, -1, d))

    @staticmethod
    def backward(ctx, gxd):
        dest, order = ctx.saved_tensors
        b, n_slots, d = gxd.shape
        s, k = order.shape[1], order.shape[2]
        # the trash slot (index n_slots) reads a zero row: a dropped choice
        # adds nothing
        gp = torch.cat([gxd, gxd.new_zeros((b, 1, d))], dim=1)
        rows = torch.gather(gp, 1, dest.reshape(b, s * k)[..., None]
                            .expand(-1, -1, d)).reshape(b, s, k, d)
        return _slot_sum(rows, order), None, None, None


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              stats: Optional[dict] = None, name: str = "moe",
              per_expert_stats: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d).  Returns (y, aux) with aux the load-balance (+ z) loss,
    a 0-d float32 tensor."""
    m = cfg.moe
    per_expert_stats = per_expert_stats or m.per_expert_factors
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    c = capacity(m, s)

    sub = {} if stats is not None else None
    logits = layers.dense(p["router"], x.float(), stats=sub,
                          name="router")                    # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)             # (B, S, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # ---- load-balance aux (Switch-style) ------------------------------ #
    assign = _one_hot(top_i, e, torch.float32)              # (B, S, k, E)
    f_e = torch.mean(torch.sum(assign, dim=2), dim=(0, 1)) / k
    p_e = torch.mean(probs, dim=(0, 1))
    aux = m.router_aux_weight * e * torch.sum(f_e * p_e)
    if m.router_z_weight:
        aux = aux + m.router_z_weight * torch.mean(
            torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- capacity dispatch (per batch row) ---------------------------- #
    choice = top_i.reshape(b, s * k)                        # (B, SK)
    oh = _one_hot(choice, e, torch.long)                    # (B, SK, E)
    pos = torch.sum((torch.cumsum(oh, dim=1) - 1) * oh, dim=-1)
    keep = pos < c
    dest = torch.where(keep, choice * c + pos,
                       torch.full_like(choice, e * c))      # trash = E·C
    src_tok = torch.arange(s, device=x.device).repeat_interleave(k)
    dis_idx = torch.full((b, e * c + 1), s, dtype=torch.long,
                         device=x.device)
    dis_idx.scatter_(1, dest, src_tok[None].expand(b, -1))
    dis_idx = dis_idx[:, :-1]                               # (B, E·C)
    dest3 = dest.reshape(b, s, k)
    order = torch.argsort(dest3, dim=-1, stable=True)  # slot order

    xd = _Dispatch.apply(x, dis_idx, dest3, order)          # (B, E·C, d)
    xd = xd.reshape(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)

    h = layers.grouped_dense(p["in"], xd, stats=sub, name="in",
                             per_expert_stats=per_expert_stats)
    g = layers.grouped_dense(p["gate"], xd, stats=sub, name="gate",
                             per_expert_stats=per_expert_stats)
    h = layers.activation(g, cfg.act) * h
    yd = layers.grouped_dense(p["out"], h, stats=sub, name="out",
                              per_expert_stats=per_expert_stats)
    yd = yd.to(x.dtype).reshape(e, b, c, d).transpose(0, 1) \
        .reshape(b, e * c, d)
    # combine: each (token, choice) reads its slot's output (a zero row for
    # a dropped choice), weighted by its gate in the output's dtype
    ydp = torch.cat([yd, yd.new_zeros((b, 1, d))], dim=1)
    rows = torch.gather(ydp, 1, dest[..., None].expand(-1, -1, d))
    gate_w = torch.where(keep, top_p.reshape(b, s * k),
                         torch.zeros_like(top_p.reshape(b, s * k)))
    rows = (rows * gate_w[..., None].to(yd.dtype)).reshape(b, s, k, d)
    out = _slot_sum(rows, order)

    if "shared" in p:
        out = out + layers.mlp(p["shared"], x, act=cfg.act, stats=sub,
                               name="shared")
    if stats is not None:
        stats[name] = sub
    return out, aux
