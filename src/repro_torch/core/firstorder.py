"""First-order optimizer backends, optax-style (port of
``repro/core/firstorder.py``).

A functional ``(init, update)`` pair over dict parameter trees rather than a
``torch.optim.Optimizer``, so that ``mkor(backend, cfg)`` wraps a backend
exactly as the reference does.  ``update`` returns *additive* updates that
already carry the ``-lr``; apply them with :func:`apply_updates`.

Step counts are 0-d int32 tensors, the reference's int32 scalars, kept on
the CPU whatever device the parameters are on: the per-step scalars (bias
corrections, learning rate) are computed from them on the host in
float32, as the reference computes them in float32 on the device, and
reading a CPU count costs no host sync.  Everything per element stays on
the tensors' device.

The per-step scalars reach the arithmetic as 0-d float32 tensors on the
parameters' device, never as Python floats.  ``plan(state)`` gives them
(and the host branch key of the next update) on the host; ``update``
takes them as ``scalars=`` (name → 0-d tensor), or makes them itself from
the same ``plan`` when none are given.  The chunk runner
(``training/loop.py``) captures a step as a CUDA graph that reads them
from buffers it writes before each replay, so a replay and an eager step
do the same arithmetic.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
State = Any
Schedule = Callable[[int], float]
# what the next update does on the host, read from the state's host counts:
# (its branch key, its per-step scalars as numpy float32 by name)
Plan = Tuple[Hashable, Dict[str, np.float32]]


class GradientTransformation(NamedTuple):
    """An optimizer as ``(init, update[, precompute[, plan[, observe]]])``.
    ``precompute`` is the two-phase async hook (the port's backends and the
    synchronous MKOR leave it ``None``).  ``plan(state)`` says what the
    next ``update`` does that a CUDA graph of it would freeze: the key of
    its host branches and its per-step scalars (``None``: the optimizer
    has no plan, and the chunk runner does not capture it).
    ``observe(state)`` reads the device state the optimizer may branch on
    (MKOR-H's sticky switch) into a host *view*: a device read, so a
    caller makes it where the device is idle anyway and passes the view
    back as ``view=`` to ``plan``, ``precompute`` and ``update``
    (``None``: the optimizer has no such state)."""
    init: Callable[[Params], State]
    update: Callable[..., Tuple[Params, State]]
    precompute: Optional[Callable[..., State]] = None
    plan: Optional[Callable[..., Plan]] = None
    observe: Optional[Callable[[State], Hashable]] = None


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


def step_count(value: int = 0) -> torch.Tensor:
    """A step count as the state holds it: 0-d int32 on the CPU."""
    return torch.tensor(value, dtype=torch.int32)


def _bias_correction(beta: float, step: int) -> np.float32:
    return np.float32(1.0) - np.float32(beta) ** np.float32(step)


def device_scalars(values: Dict[str, np.float32],
                   device) -> Dict[str, torch.Tensor]:
    """Per-step scalars as 0-d float32 tensors on ``device`` (a fill each:
    no host-to-device copy, no sync)."""
    return {k: torch.full((), float(v), dtype=torch.float32, device=device)
            for k, v in values.items()}


def _adam_moments(grads, state, b1, b2):
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                 state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)
    return m, v


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> GradientTransformation:
    """SGD with optional (Nesterov) momentum and L2 weight decay added to
    the gradient.  Without momentum the state's ``mu`` is ``None``, as in
    the reference."""
    lr = as_schedule(lr)

    def init(params):
        return {"count": step_count(),
                "mu": _tree_zeros(params) if momentum else None}

    def plan(state) -> Plan:
        return (), {"lr": np.float32(lr(int(state["count"])))}

    def update(grads, state, params=None, scalars=None, **_):
        step = int(state["count"])
        if scalars is None:
            scalars = device_scalars(plan(state)[1],
                                     tree_leaves(grads)[0].device)
        if weight_decay and params is not None:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(),
                          state["mu"], grads)
            d = tree_map(lambda m, g: momentum * m + g.float(), mu,
                         grads) if nesterov else mu
        else:
            mu, d = None, grads
        lr_t = scalars["lr"]
        updates = tree_map(lambda g, p: (-lr_t * g.float()).to(p.dtype), d,
                           params if params is not None else d)
        return updates, {"count": step_count(step + 1), "mu": mu}

    return GradientTransformation(init, update, None, plan)


def _adam_plan(lr, b1, b2):
    """The per-step scalars of Adam and LAMB: the learning rate at
    ``count`` and the bias corrections at ``count + 1``."""
    def plan(state) -> Plan:
        step = int(state["count"]) + 1
        return (), {"lr": np.float32(lr(step - 1)),
                    "bc1": _bias_correction(b1, step),
                    "bc2": _bias_correction(b2, step)}
    return plan


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> GradientTransformation:
    """Adam; with ``weight_decay > 0`` this is AdamW (decoupled)."""
    lr = as_schedule(lr)
    plan = _adam_plan(lr, b1, b2)

    def init(params):
        return {"count": step_count(), "m": _tree_zeros(params),
                "v": _tree_zeros(params)}

    def update(grads, state, params=None, scalars=None, **_):
        step = int(state["count"]) + 1
        if scalars is None:
            scalars = device_scalars(plan(state)[1],
                                     tree_leaves(grads)[0].device)
        m, v = _adam_moments(grads, state, b1, b2)
        bc1, bc2, lr_t = scalars["bc1"], scalars["bc2"], scalars["lr"]

        def upd(m, v, p):
            d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                d = d + weight_decay * p.float()
            return (-lr_t * d).to(p.dtype)

        updates = tree_map(upd, m, v, params if params is not None else m)
        return updates, {"count": step_count(step), "m": m, "v": v}

    return GradientTransformation(init, update, None, plan)


def adamw(lr, weight_decay: float = 0.01, **kw) -> GradientTransformation:
    return adam(lr, weight_decay=weight_decay, **kw)


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01,
         trust_clip: Optional[float] = 10.0) -> GradientTransformation:
    """LAMB (You et al., arXiv:1904.00962): Adam moments, decoupled weight
    decay and a per-leaf trust ratio ‖p‖/‖r‖ (clipped at ``trust_clip``).
    A leaf is one tensor of the tree, so a stacked ``(n_layers, ...)`` leaf
    shares one trust ratio, exactly as in the reference."""
    lr = as_schedule(lr)
    plan = _adam_plan(lr, b1, b2)

    def init(params):
        return {"count": step_count(), "m": _tree_zeros(params),
                "v": _tree_zeros(params)}

    def update(grads, state, params=None, scalars=None, **_):
        if params is None:
            raise ValueError("lamb needs params (trust ratio)")
        step = int(state["count"]) + 1
        if scalars is None:
            scalars = device_scalars(plan(state)[1],
                                    tree_leaves(params)[0].device)
        m, v = _adam_moments(grads, state, b1, b2)
        bc1, bc2, lr_t = scalars["bc1"], scalars["bc2"], scalars["lr"]

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
        return updates, {"count": step_count(step), "m": m, "v": v}

    return GradientTransformation(init, update, None, plan)


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
