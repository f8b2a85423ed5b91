"""MKOR: Momentum-Enabled Kronecker-Factor-Based Optimizer Using Rank-1
Updates — the port of the main path of ``repro/core/mkor.py``.

Per eligible 2-D layer with weight W (d_in, d_out), gradient G, rank-1
statistics ā = E[a] (d_in,) and ḡ = E[g] (d_out,):

  line 5/6  norm-based stabilizer:   if ‖F⁻¹‖∞ > ε:  F⁻¹ ← ζF⁻¹ + (1−ζ)I
  line 7/8  SM-based factor inversion (Eq. 5/6, O(d²)):
      L⁻¹ ← γL⁻¹ + (1−γ) / (γ²(1 + γ(1−γ) ḡᵀL⁻¹ḡ)) · (L⁻¹ḡ)(L⁻¹ḡ)ᵀ
      R⁻¹ ← (same with ā)
  line 9    precondition:            ΔW = R⁻¹ G L⁻¹
  line 10   rescale:                 ΔW ← ΔW · ‖G‖_F / ‖ΔW‖_F
  line 14   backend step (LAMB / momentum-SGD / ...)

Factors live in shape-bucketed *banks* (``layout="bank"``): every eligible
layer is grouped by ``(stack, extra, d_in, d_out)`` (core/stats.py) and
each bucket owns ``l_inv: (n_slots, *stack, d_out, d_out)`` and
``r_inv: (n_slots, *stack, d_in, d_in)``.  ``update`` runs stabilize →
SMW → precondition → rescale once per bucket over the whole bank.  With
``stagger`` the bucket at index i inverts on steps where
``count % inv_freq == i % inv_freq``; off-phase steps skip the inversion
(a Python branch on the host-side step count, where the reference uses
``lax.cond``).

``use_kernels=True`` (the reference's ``use_pallas``) routes the banked
SMW and the precondition through the hand-written CUDA kernels
(``kernels/ops.py``: one ``fused_smw`` launch per bucket side per phase
step, one ``fused_precond`` launch per bucket per step); otherwise the
same math runs as plain batched PyTorch.  Either way ``update`` is
functional: the state passed in is not modified (the SMW kernel updates
the freshly stabilized copy of a bank in place, which saves a second
bank-sized buffer).

Ported so far: the main-path configuration — bank layout, rank 1,
staleness 0, stagger on or off, ``variant`` ``paper`` and ``exact_smw``,
factor storage ``none`` / ``bf16``, health, int8 and dist off.  Other
settings raise ``NotImplementedError`` naming their ROADMAP item.
``MKORConfig`` keeps every field of the reference with the same default,
with ``use_pallas`` renamed ``use_kernels`` and the Pallas-only
``interpret`` dropped.  The state holds ``count``, ``factor_banks`` and
``backend``; the reference's ``hybrid`` entry arrives with ``mkor_h``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import stats as statlib
from repro_torch.core.firstorder import GradientTransformation
from repro_torch.kernels import ops as kops
from repro_torch.kernels.precond import rescale_update  # Alg. 1 line 10


@dataclass(frozen=True)
class MKORConfig:
    gamma: float = 0.9                 # factor momentum (Eqs. 3-6)
    inv_freq: int = 10                 # update factors every f steps
    stabilizer_threshold: float = 50.0  # ε: ‖F⁻¹‖∞ trigger (lines 5-6)
    zeta: float = 0.95                 # blend-toward-identity strength
    factor_dtype: str = "bfloat16"     # paper: half precision
    factor_quant: str = "none"         # "none" | "bf16" | "int8"
    max_factor_dim: int = 32768        # skip layers with huge factor dims
    min_factor_dim: int = 4
    rescale: bool = True               # line 10 gradient rescaling
    exclude: Tuple[str, ...] = ("embed", "lm_head")
    variant: str = "paper"             # "paper" | "exact_smw"
    rank: int = 1
    use_kernels: bool = False          # hand-written CUDA kernels (kernels/)
    layout: str = "bank"               # "bank" (bucketed) | "per_layer"
    stagger: bool = True
    staleness: int = 0
    health: bool = False
    health_cooldown: int = 2
    health_norm_factor: float = 4.0
    health_pivot_tol: float = 1e-12
    dist: Optional[Tuple[Tuple[str, int], ...]] = None
    live: Optional[Tuple[bool, ...]] = None
    hybrid: bool = False
    hybrid_ema_fast: float = 0.9
    hybrid_ema_slow: float = 0.99
    hybrid_threshold: float = 0.02
    hybrid_min_steps: int = 50


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def factor_storage_dtype(cfg: MKORConfig) -> torch.dtype:
    """Resident dtype of the factor banks."""
    return torch.bfloat16 if cfg.factor_quant == "bf16" \
        else _DTYPES[cfg.factor_dtype]


def _check_supported(cfg: MKORConfig) -> None:
    todo = [
        (cfg.layout != "bank", "layout='per_layer' (ROADMAP queue 1 item "
         "20)"),
        (cfg.rank != 1, "rank > 1 (ROADMAP queue 1 item 12)"),
        (cfg.staleness != 0, "staleness=1 (ROADMAP queue 1 item 13)"),
        (cfg.health, "health=True (ROADMAP queue 1 item 14)"),
        (cfg.factor_quant == "int8", "factor_quant='int8' (ROADMAP queue 1 "
         "item 15)"),
        (cfg.dist is not None or cfg.live is not None,
         "dist / live (ROADMAP queue 1 items 16-17)"),
        (cfg.hybrid, "hybrid / mkor_h (ROADMAP queue 1 item 10)"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"MKOR port: {what} is not ported yet")
    if cfg.variant not in ("paper", "exact_smw"):
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.factor_quant not in ("none", "bf16"):
        raise ValueError(f"unknown factor_quant {cfg.factor_quant!r}")


# ----------------------------------------------------------------------- #
# Core math (single factor, single layer), as in the reference
# ----------------------------------------------------------------------- #
def smw_rank1_update(j_inv: torch.Tensor, v: torch.Tensor, gamma: float,
                     variant: str = "paper") -> torch.Tensor:
    """One rank-1 SM-based inverse update (paper Eq. 5/6), O(d²), for a
    factor (..., d, d) and its statistic (..., d); leading dims batch."""
    jf, vf = j_inv.float(), v.float()
    u = torch.matmul(jf, vf[..., None])[..., 0]
    s = torch.sum(vf * u, dim=-1)[..., None, None]         # ḡᵀ J⁻¹ ḡ (fp32)
    uu = u[..., :, None] * u[..., None, :]
    if variant == "paper":
        coef = (1.0 - gamma) / (gamma ** 2 * (1.0 + gamma * (1.0 - gamma)
                                              * s))
        new = gamma * jf + coef * uu
    elif variant == "exact_smw":
        # (γJ + (1-γ)vvᵀ)⁻¹ = (1/γ)(J⁻¹ − (1−γ) uuᵀ / (γ + (1−γ)s))
        new = (jf - (1.0 - gamma) * uu / (gamma + (1.0 - gamma) * s)) / gamma
    else:
        raise ValueError(variant)
    return new.to(j_inv.dtype)


def stabilize(j_inv: torch.Tensor, threshold: float,
              zeta: float) -> torch.Tensor:
    """Norm-based stabilizer (lines 5-6 / Eqs. 7-8) plus the norm cap of the
    reference, per (d, d) slice of any leading dims."""
    jf = j_inv.float()
    norm = torch.amax(torch.abs(jf), dim=(-2, -1), keepdim=True)
    eye = torch.eye(j_inv.shape[-1], dtype=torch.float32,
                    device=j_inv.device)
    blended = zeta * jf + (1.0 - zeta) * eye
    out = torch.where(norm > threshold, blended, jf)
    n2 = torch.amax(torch.abs(out), dim=(-2, -1), keepdim=True)
    out = torch.where(n2 > threshold,
                      out * (threshold / torch.clamp(n2, min=1e-30)), out)
    return out.to(j_inv.dtype)


def precondition(l_inv: torch.Tensor, r_inv: torch.Tensor,
                 g_w: torch.Tensor) -> torch.Tensor:
    """ΔW = R⁻¹ G L⁻¹ in fp32.  Factors (*lead, d, d) and g_w (*lead,
    *extra, d_in, d_out): the factors broadcast over the extra dims
    (experts under shared factors), as in the reference."""
    n_extra = g_w.ndim - r_inv.ndim

    def bcast(f):
        return f.float().reshape(tuple(f.shape[:-2]) + (1,) * n_extra
                                 + tuple(f.shape[-2:]))
    return torch.matmul(torch.matmul(bcast(r_inv), g_w.float()),
                        bcast(l_inv))


# ----------------------------------------------------------------------- #
# The optimizer
# ----------------------------------------------------------------------- #
def _eligible(path, dense, cfg: MKORConfig) -> bool:
    _, _, d_in, d_out = statlib.layer_dims(dense)
    if any(str(p) in cfg.exclude for p in path):
        return False
    lo, hi = cfg.min_factor_dim, cfg.max_factor_dim
    return lo <= d_in <= hi and lo <= d_out <= hi


def manifest_for(tree, cfg: MKORConfig) -> statlib.BucketManifest:
    return statlib.build_bucket_manifest(
        tree, lambda path, dense: _eligible(path, dense, cfg))


def mkor(backend: GradientTransformation,
         cfg: MKORConfig = MKORConfig()) -> GradientTransformation:
    """MKOR wrapping a first-order ``backend`` (Alg. 1)."""
    _check_supported(cfg)
    store_dtype = factor_storage_dtype(cfg)

    def stab(bank):
        return stabilize(bank, cfg.stabilizer_threshold, cfg.zeta)

    def banked_smw(bank, v):
        """Stabilize, then rank-1 SMW over a whole bank (*lead, d, d)."""
        jb = stab(bank)
        if cfg.use_kernels:
            return kops.smw_rank1_update_banked(
                jb, v, gamma=cfg.gamma, variant=cfg.variant, out=jb)
        return smw_rank1_update(jb, v, cfg.gamma, cfg.variant)

    def banked_precond(l_bank, r_bank, gw, n_lead):
        if cfg.use_kernels:
            delta = kops.fused_precondition_banked(l_bank, r_bank, gw,
                                                   rescale=cfg.rescale)
        else:
            delta = precondition(l_bank, r_bank, gw)
            if cfg.rescale:
                delta = rescale_update(delta, gw, n_lead)
        return delta.to(gw.dtype)

    def init(params):
        banks = {}
        for b in manifest_for(params, cfg):
            shape = (b.n_slots,) + b.stack
            dev = statlib.tree_get(params, b.paths[0])["w"].device

            def eye(d):
                return torch.eye(d, dtype=store_dtype, device=dev).expand(
                    shape + (d, d)).contiguous()

            banks[b.bucket_id] = {"l_inv": eye(b.d_out),
                                  "r_inv": eye(b.d_in)}
        return {"count": 0, "factor_banks": banks,
                "backend": backend.init(params)}

    def update(grads, state, params=None, stats=None, **_):
        count = state["count"]
        tree = params if params is not None else grads
        manifest = manifest_for(tree, cfg)
        phases = statlib.bucket_phases(manifest, cfg.inv_freq, cfg.stagger)
        new_banks: Dict[str, Dict[str, torch.Tensor]] = {}
        out = grads
        for bucket in manifest:
            bank = state["factor_banks"][bucket.bucket_id]
            l_bank, r_bank = bank["l_inv"], bank["r_inv"]
            n_lead = 1 + len(bucket.stack)
            g_ws, g_vecs, a_vecs = [], [], []
            for path in bucket.paths:
                g_ws.append(statlib.tree_get(grads, path)["w"])
                g_vecs.append(statlib.get_g_vec(grads, path))
                a_vecs.append(statlib.get_a_vec(stats, path)
                              if stats is not None else None)

            # --- lines 5-8, on this bucket's phase steps only.  Slots
            # without stats this step keep their factors untouched. ------ #
            slots = [i for i, (av, gv) in enumerate(zip(a_vecs, g_vecs))
                     if av is not None and gv is not None]
            if slots and count % cfg.inv_freq == phases[bucket.bucket_id]:
                gv = torch.stack([g_vecs[i] for i in slots]).float()
                av = torch.stack([a_vecs[i] for i in slots]).float()
                if len(slots) == bucket.n_slots:
                    l_bank = banked_smw(l_bank, gv)
                    r_bank = banked_smw(r_bank, av)
                else:
                    idx = torch.tensor(slots, device=l_bank.device)
                    l_bank = l_bank.index_copy(0, idx, banked_smw(
                        l_bank.index_select(0, idx), gv))
                    r_bank = r_bank.index_copy(0, idx, banked_smw(
                        r_bank.index_select(0, idx), av))
            new_banks[bucket.bucket_id] = {"l_inv": l_bank, "r_inv": r_bank}

            # --- lines 9-10: one precondition + rescale per bucket ------- #
            delta = banked_precond(l_bank, r_bank, torch.stack(g_ws), n_lead)
            for i, path in enumerate(bucket.paths):
                out = statlib.tree_set(
                    out, path, {**statlib.tree_get(out, path), "w": delta[i]})

        # probes are stat taps: never step them, keep backend moments clean
        out = statlib.zero_probes(out)
        updates, backend_state = backend.update(out, state["backend"],
                                                params=params)
        updates = statlib.zero_probes(updates)
        return updates, {"count": count + 1, "factor_banks": new_banks,
                         "backend": backend_state}

    return GradientTransformation(init, update)
