"""SNGD baseline (HyLo-style Sherman-Morrison-Woodbury NGD, paper §8.3),
the port of ``repro/core/sngd.py``.

Preconditions with the SMW identity on the damped FIM block (Eq. 13):

  (F + μI)⁻¹ ∇w = (1/μ) (∇w − U (AAᵀ ∘ G̃G̃ᵀ + NμI)⁻¹ Uᵀ ∇w),

where U's columns are the per-sample gradients u_i = vec(a_i g̃_iᵀ), and
the N×N kernel is solved (``torch.linalg.solve``): the O(N³) cost that
grows with the tokens of a batch.  Every product is matrix-free, from the
full per-token stats ``{"A": (N, d_in), "G": (N, d_out)}``
(``core/baseline_net.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import GradientTransformation, step_count
from repro_torch.kernels.precond import rescale_update


@dataclass(frozen=True)
class SNGDConfig:
    damping: float = 1e-2               # μ
    inv_freq: int = 1                   # the kernel is rebuilt every step
    exclude: Tuple[str, ...] = ("embed", "lm_head")
    rescale: bool = True


def sngd_precondition(a_mat: torch.Tensor, g_mat: torch.Tensor,
                      g_w: torch.Tensor, damping: float) -> torch.Tensor:
    """Matrix-free SMW preconditioning of one layer's gradient, in fp32
    (in float64 for float64 inputs, which the optimizer never passes: a
    yardstick of the same formula)."""
    dt = torch.promote_types(a_mat.dtype, torch.float32)
    a = a_mat.to(dt)
    n = a.shape[0]
    g = g_mat.to(dt) * n                    # per-token grads (undo 1/N)
    gw = g_w.to(dt)
    ug = torch.sum(torch.matmul(a, gw) * g, dim=-1)          # Uᵀ∇w (N,)
    kern = torch.matmul(a, a.T) * torch.matmul(g, g.T) + n * damping \
        * torch.eye(n, dtype=dt, device=a.device)
    z = torch.linalg.solve(kern, ug)
    uz = torch.matmul((z[:, None] * a).T, g)                  # U z
    return (gw - uz) / damping


def sngd(backend: GradientTransformation,
         cfg: SNGDConfig = SNGDConfig()) -> GradientTransformation:
    """SNGD wrapping a first-order ``backend``."""

    def init(params):
        return {"count": step_count(), "backend": backend.init(params)}

    def update(grads, state, params=None, stats=None, **_):
        out = grads
        for path in statlib.iter_dense_layers(grads):
            if any(str(p) in cfg.exclude for p in path):
                continue
            node = statlib.tree_get(stats, path) if stats is not None \
                else None
            if node is None or "A" not in node or "G" not in node:
                continue
            g_w = statlib.tree_get(grads, path)["w"]
            if g_w.ndim != 2:
                continue
            delta = sngd_precondition(node["A"], node["G"], g_w,
                                      cfg.damping)
            if cfg.rescale:
                delta = rescale_update(delta, g_w)
            out = statlib.tree_set(
                out, path,
                {**statlib.tree_get(out, path), "w": delta.to(g_w.dtype)})

        out = statlib.zero_probes(out)
        updates, bstate = backend.update(out, state["backend"],
                                         params=params)
        updates = statlib.zero_probes(updates)
        return updates, {"count": step_count(int(state["count"]) + 1),
                         "backend": bstate}

    return GradientTransformation(init, update)
