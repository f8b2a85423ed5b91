"""KFAC baseline (KAISA-style KFAC, the paper's main second-order
comparison point), the port of ``repro/core/kfac.py``.

Keeps EMA'd Kronecker factors L = E[g gᵀ] and R = E[a aᵀ] (Eqs. 3-4) from
*full* per-token statistics and inverts them every ``inv_freq`` steps
with Tikhonov damping, through an eigendecomposition with its eigenvalues
clipped at ``eig_clip``: the O(d³) work MKOR removes.

Stats: ``stats[path] = {"A": (N, d_in), "G": (N, d_out)}`` (per-token
activations and output gradients from ``core/baseline_net.py``).  The G
rows follow the mean-loss convention (each row is dℓ_t/dy_t / N), so L
is scaled by N.  As in the reference, only unstacked layers are
preconditioned (``if stack: continue``): on a scan-stacked model KFAC is
its backend alone.  The inversion step is a host branch on the CPU step
count, as MKOR's schedule is; off it the inverses are carried.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import GradientTransformation, step_count


@dataclass(frozen=True)
class KFACConfig:
    gamma: float = 0.9                  # factor EMA (Eqs. 3-4)
    inv_freq: int = 100                 # KAISA-style stale factors
    damping: float = 1e-3               # μ
    eig_clip: float = 1e-8
    max_factor_dim: int = 8192
    min_factor_dim: int = 2
    exclude: Tuple[str, ...] = ("embed", "lm_head")
    rescale: bool = True


def damped_inverse(cov: torch.Tensor, damping: float,
                   eig_clip: float) -> torch.Tensor:
    """(cov + μI)⁻¹ by ``torch.linalg.eigh``, the eigenvalues clipped at
    ``eig_clip`` (O(d³))."""
    d = cov.shape[-1]
    w, v = torch.linalg.eigh(cov + damping * torch.eye(
        d, dtype=cov.dtype, device=cov.device))
    w = torch.clamp(w, min=eig_clip)
    return torch.matmul(v / w[..., None, :], v.transpose(-1, -2))


def kfac(backend: GradientTransformation,
         cfg: KFACConfig = KFACConfig()) -> GradientTransformation:
    """KFAC wrapping a first-order ``backend``."""

    def init(params):
        factors = {}
        for path in statlib.iter_dense_layers(params):
            dense = statlib.tree_get(params, path)
            stack, _, d_in, d_out = statlib.layer_dims(dense)
            if stack:
                continue                    # unstacked nets only (baseline)
            if any(str(p) in cfg.exclude for p in path):
                continue
            if not (cfg.min_factor_dim <= d_in <= cfg.max_factor_dim
                    and cfg.min_factor_dim <= d_out <= cfg.max_factor_dim):
                continue
            dev = dense["w"].device

            def eye(d):
                return torch.eye(d, dtype=torch.float32, device=dev)
            factors[statlib.path_str(path)] = {
                "l_cov": eye(d_out), "r_cov": eye(d_in),
                "l_inv": eye(d_out), "r_inv": eye(d_in)}
        return {"count": step_count(), "factors": factors,
                "backend": backend.init(params)}

    def update(grads, state, params=None, stats=None, **_):
        count = int(state["count"])
        do_inv = count % cfg.inv_freq == 0
        layer_paths = {statlib.path_str(p): p
                       for p in statlib.iter_dense_layers(grads)}
        out = grads
        new_factors = {}
        for key, fac in state["factors"].items():
            path = layer_paths[key]
            g_w = statlib.tree_get(grads, path)["w"]
            node = statlib.tree_get(stats, path) if stats is not None \
                else None
            l_cov, r_cov = fac["l_cov"], fac["r_cov"]
            if node is not None and "A" in node and "G" in node:
                a_mat, g_mat = node["A"].float(), node["G"].float()
                n = a_mat.shape[0]
                # Eqs. 3-4 (G rows carry 1/N from the mean loss: times N)
                l_new = torch.matmul(g_mat.T, g_mat) * n
                r_new = torch.matmul(a_mat.T, a_mat) / n
                l_cov = cfg.gamma * l_cov + (1 - cfg.gamma) * l_new
                r_cov = cfg.gamma * r_cov + (1 - cfg.gamma) * r_new
            l_inv, r_inv = fac["l_inv"], fac["r_inv"]
            if do_inv:
                l_inv = damped_inverse(l_cov, cfg.damping, cfg.eig_clip)
                r_inv = damped_inverse(r_cov, cfg.damping, cfg.eig_clip)
            new_factors[key] = {"l_cov": l_cov, "r_cov": r_cov,
                                "l_inv": l_inv, "r_inv": r_inv}
            delta = torch.matmul(torch.matmul(r_inv, g_w.float()), l_inv)
            if cfg.rescale:
                gn = torch.linalg.vector_norm(g_w.float())
                dn = torch.linalg.vector_norm(delta)
                delta = delta * gn / torch.clamp(dn, min=1e-30)
            out = statlib.tree_set(
                out, path,
                {**statlib.tree_get(out, path), "w": delta.to(g_w.dtype)})

        out = statlib.zero_probes(out)
        updates, bstate = backend.update(out, state["backend"],
                                         params=params)
        updates = statlib.zero_probes(updates)
        return updates, {"count": step_count(count + 1),
                         "factors": new_factors, "backend": bstate}

    return GradientTransformation(init, update)
