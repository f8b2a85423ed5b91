"""First-order optimizer backends, optax-style (port of
``repro/core/firstorder.py``).

A functional ``(init, update)`` pair over dict parameter trees rather than a
``torch.optim.Optimizer``, so that ``mkor(backend, cfg)`` wraps a backend
exactly as the reference does.  ``update`` returns *additive* updates that
already carry the ``-lr``; apply them with :func:`apply_updates`.

Step counts are Python ints and the per-step scalars (bias corrections,
learning rate) are computed on the host in float32, as the reference
computes them in float32 on the device; everything per element stays on
the tensors' device, with no host sync.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
State = Any
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """An optimizer as an ``(init, update[, precompute])`` triple
    (``precompute`` is the two-phase async hook; the port's backends and
    the synchronous MKOR leave it ``None``)."""
    init: Callable[[Params], State]
    update: Callable[..., Tuple[Params, State]]
    precompute: Optional[Callable[..., State]] = None


def _tree_zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in float32 (a 0-d tensor)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    value = float(np.float32(lr))
    return lambda step: value


def _bias_correction(beta: float, step: int) -> float:
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def _adam_moments(grads, state, b1, b2):
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                 state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)
    return m, v


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01,
         trust_clip: Optional[float] = 10.0) -> GradientTransformation:
    """LAMB (You et al., arXiv:1904.00962): Adam moments, decoupled weight
    decay and a per-leaf trust ratio ‖p‖/‖r‖ (clipped at ``trust_clip``).
    A leaf is one tensor of the tree, so a stacked ``(n_layers, ...)`` leaf
    shares one trust ratio, exactly as in the reference."""
    lr = as_schedule(lr)

    def init(params):
        return {"count": 0, "m": _tree_zeros(params), "v": _tree_zeros(params)}

    def update(grads, state, params=None, **_):
        if params is None:
            raise ValueError("lamb needs params (trust ratio)")
        step = state["count"] + 1
        m, v = _adam_moments(grads, state, b1, b2)
        bc1 = _bias_correction(b1, step)
        bc2 = _bias_correction(b2, step)
        lr_t = float(np.float32(lr(step - 1)))

        def upd(m, v, p):
            r = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            r = r + weight_decay * p.float()
            pn = torch.linalg.vector_norm(p.float())
            rn = torch.linalg.vector_norm(r)
            trust = torch.where((pn > 0) & (rn > 0),
                                pn / torch.clamp(rn, min=1e-12),
                                torch.ones_like(pn))
            if trust_clip is not None:
                trust = torch.clamp(trust, max=trust_clip)
            return ((-lr_t * trust) * r).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"count": step, "m": m, "v": v}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(grads, state, params=None, **_):
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype),
                        grads), state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None, **extra):
        new_states = []
        for t, s in zip(transforms, state):
            grads, ns = t.update(grads, s, params=params, **extra)
            new_states.append(ns)
        return grads, tuple(new_states)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``p + u`` in float32, cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
