"""Plain PyTorch oracles for the kernels, one slice at a time (port of
``repro/kernels/ref.py``).  Independent of the kernels and of the batched
plain versions that sit beside each kernel wrapper; everything is
computed in float32."""
from __future__ import annotations

import torch


def matvec_ref(j: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u = J v.  j (d, d), v (d, 1) → (d, 1) fp32."""
    return j.float() @ v.float()


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    return (a.float() @ b.float()).to(out_dtype)


def smw_coef_ref(s: torch.Tensor, gamma: float, variant: str) -> torch.Tensor:
    """Scalar coefficient of the rank-1 term (paper Eq. 5/6 or exact SMW)."""
    s = s.float()
    if variant == "paper":
        return (1.0 - gamma) / (gamma ** 2 * (1.0 + gamma * (1.0 - gamma) * s))
    if variant == "exact_smw":
        return -(1.0 - gamma) / (gamma * (gamma + (1.0 - gamma) * s))
    raise ValueError(variant)


def smw_rank1_update_ref(j_inv: torch.Tensor, v: torch.Tensor, gamma: float,
                         variant: str = "paper") -> torch.Tensor:
    """Full SMW rank-1 inverse update (Alg. 1 line 7/8) of one factor."""
    jf, vf = j_inv.float(), v.float()
    u = jf @ vf
    s = vf @ u
    coef = smw_coef_ref(s, gamma, variant)
    scale = gamma if variant == "paper" else 1.0 / gamma
    return (scale * jf + coef * torch.outer(u, u)).to(j_inv.dtype)


def smw_rank1_update_banked_ref(j: torch.Tensor, v: torch.Tensor,
                                gamma: float,
                                variant: str = "paper") -> torch.Tensor:
    """Per-slice (chained rank-r) SMW over the flattened leading dims of
    j (*lead, d, d) / v (*lead, [r,] d)."""
    d = j.shape[-1]
    lead = j.shape[:-2]
    jf = j.reshape(-1, d, d)
    vf = v.reshape((jf.shape[0],) + tuple(v.shape[len(lead):]))
    outs = []
    for i in range(jf.shape[0]):
        ji, vi = jf[i], vf[i]
        if vi.ndim == 1:
            vi = vi[None]
        for r in range(vi.shape[0]):
            ji = smw_rank1_update_ref(ji, vi[r], gamma, variant)
        outs.append(ji)
    return torch.stack(outs).reshape(j.shape)


def two_sided_precondition_ref(l_inv: torch.Tensor, r_inv: torch.Tensor,
                               g_w: torch.Tensor) -> torch.Tensor:
    """ΔW = R⁻¹ G L⁻¹ (fp32); extra leading dims of g_w broadcast."""
    out = torch.einsum("ij,...jk->...ik", r_inv.float(), g_w.float())
    return torch.einsum("...ik,kl->...il", out, l_inv.float())


def fused_precondition_ref(l_inv: torch.Tensor, r_inv: torch.Tensor,
                           g_w: torch.Tensor,
                           rescale: bool = True) -> torch.Tensor:
    """Lines 9-10: precondition + Frobenius rescale (guard ε = 1e-30)."""
    delta = two_sided_precondition_ref(l_inv, r_inv, g_w)
    if not rescale:
        return delta
    gf = g_w.float()
    gn = torch.sqrt(torch.sum(gf * gf))
    dn = torch.sqrt(torch.sum(delta * delta))
    return delta * (gn / torch.clamp(dn, min=1e-30))
