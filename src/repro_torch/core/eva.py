"""Eva baseline (Zhang et al. 2023), the port of ``repro/core/eva.py``.

Eva keeps EMA'd Kronecker *vectors* (like MKOR's rank-1 statistics) and
inverts the implied rank-1-plus-damping factor analytically each step,

    (v vᵀ + μ I)⁻¹ = (1/μ) (I − v vᵀ / (μ + vᵀv)),

applied matrix-free to the gradient from both sides, then rescaled to the
gradient's Frobenius norm.  It shares MKOR's rank-1 stats interface (ā
from the forward pass, ḡ from the probe gradients), so it trains every
model MKOR trains.

The ``seen`` flag of a layer is a 0-d bool on the parameters' device that
a ``where`` reads (the first statistics replace the zero EMAs), never the
host, so a CUDA graph of the step holds it.  ``count`` is a 0-d int32 on
the CPU, and ``plan`` is the backend's, so the chunk runner captures an
Eva step as it captures its backend's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import GradientTransformation, step_count
from repro_torch.kernels.precond import rescale_update
from repro_torch.training import phases
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class EvaConfig:
    gamma: float = 0.9
    damping: float = 1e-3
    max_factor_dim: int = 32768
    min_factor_dim: int = 4
    exclude: Tuple[str, ...] = ("embed", "lm_head")
    rescale: bool = True


def _rank1_damped_apply(v: torch.Tensor, x: torch.Tensor, mu: float,
                        side: str) -> torch.Tensor:
    """(vvᵀ + μI)⁻¹ applied to x on the left (side='l': x (..., d, e), its
    rows indexed by v's dim) or on the right (side='r': x (..., e, d)),
    matrix-free, in fp32; leading dims of v (..., d) and x batch."""
    v = v.float()
    x = x.float()
    s = torch.sum(v * v, dim=-1)[..., None, None] + mu
    if side == "l":
        vx = torch.matmul(v[..., None, :], x)               # (..., 1, e)
        return (x - v[..., :, None] * vx / s) / mu
    xv = torch.matmul(x, v[..., :, None])                   # (..., e, 1)
    return (x - xv * v[..., None, :] / s) / mu


def eva_precondition(a: torch.Tensor, g: torch.Tensor, g_w: torch.Tensor,
                     cfg: EvaConfig) -> torch.Tensor:
    """One layer's update: (aaᵀ + μI)⁻¹ G (ggᵀ + μI)⁻¹, each (d_in, d_out)
    slice rescaled alone, in g_w's dtype.  a (*stack, d_in), g (*stack,
    d_out), g_w (*stack, *extra, d_in, d_out): the vectors broadcast over
    the extra dims (experts under shared factors)."""
    n_extra = g_w.ndim - 2 - (a.ndim - 1)

    def bcast(v):
        return v.reshape(tuple(v.shape[:-1]) + (1,) * n_extra
                         + tuple(v.shape[-1:]))
    d = _rank1_damped_apply(bcast(a), g_w, cfg.damping, "l")
    d = _rank1_damped_apply(bcast(g), d, cfg.damping, "r")
    if cfg.rescale:
        d = rescale_update(d, g_w, g_w.ndim - 2)
    return d.to(g_w.dtype)


def eva(backend: GradientTransformation,
        cfg: EvaConfig = EvaConfig()) -> GradientTransformation:
    """Eva wrapping a first-order ``backend``."""

    def init(params):
        vecs = {}
        for path in statlib.iter_dense_layers(params):
            dense = statlib.tree_get(params, path)
            stack, _, d_in, d_out = statlib.layer_dims(dense)
            if any(str(p) in cfg.exclude for p in path):
                continue
            if not (cfg.min_factor_dim <= d_in <= cfg.max_factor_dim
                    and cfg.min_factor_dim <= d_out <= cfg.max_factor_dim):
                continue
            dev = dense["w"].device
            vecs[statlib.path_str(path)] = {
                "a": torch.zeros(stack + (d_in,), dtype=torch.float32,
                                 device=dev),
                "g": torch.zeros(stack + (d_out,), dtype=torch.float32,
                                 device=dev),
                "seen": torch.zeros((), dtype=torch.bool, device=dev),
            }
        return {"count": step_count(), "vecs": vecs,
                "backend": backend.init(params)}

    def plan(state):
        """The backend's plan: Eva has no host branch of its own."""
        return backend.plan(state["backend"])

    def update(grads, state, params=None, stats=None, scalars=None, **_):
        device = tree_leaves(grads)[0].device
        phases.mark("second_order", device)
        layer_paths = {statlib.path_str(p): p
                       for p in statlib.iter_dense_layers(grads)}
        out = grads
        new_vecs = {}
        for key, vec in state["vecs"].items():
            path = layer_paths[key]
            g_w = statlib.tree_get(grads, path)["w"]
            a_new = statlib.get_a_vec(stats, path) if stats is not None \
                else None
            g_new = statlib.get_g_vec(grads, path)
            a_ema, g_ema, seen = vec["a"], vec["g"], vec["seen"]
            if a_new is not None and g_new is not None:
                def blend(old, new):
                    new = new.float()
                    return torch.where(seen, cfg.gamma * old
                                       + (1 - cfg.gamma) * new, new)
                a_ema, g_ema = blend(a_ema, a_new), blend(g_ema, g_new)
                seen = torch.ones_like(seen)
            new_vecs[key] = {"a": a_ema, "g": g_ema, "seen": seen}
            delta = eva_precondition(a_ema, g_ema, g_w, cfg)
            out = statlib.tree_set(
                out, path, {**statlib.tree_get(out, path), "w": delta})

        out = statlib.zero_probes(out)
        phases.mark("first_order", device)
        updates, bstate = backend.update(out, state["backend"],
                                         params=params, scalars=scalars)
        updates = statlib.zero_probes(updates)
        return updates, {"count": step_count(int(state["count"]) + 1),
                         "vecs": new_vecs, "backend": bstate}

    return GradientTransformation(init, update, None,
                                  plan if backend.plan is not None else None)
