"""Plain PyTorch oracles for the kernels, one slice at a time (port of
``repro/kernels/ref.py``).  Independent of the kernels and of the batched
plain versions that sit beside each kernel wrapper; everything is
computed in float32."""
from __future__ import annotations

from typing import Optional

import torch


def dequant_ref(q: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 decode of int8 factor codes (*lead, d, d) with their per-slice
    scales (``lead``-shaped, or a scalar for one slice); ``scale=None``
    just casts (a bf16 or fp32 factor).  The plain versions of the kernels
    decode with it."""
    qf = q.float()
    if scale is None:
        return qf
    return qf * torch.as_tensor(scale, dtype=torch.float32,
                                device=q.device)[..., None, None]


def scale_slices(x: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, ...) times its (B,) per-slice scale, as the GEMM epilogues
    apply an int8 operand's scale to its product; ``None`` leaves x."""
    return x if scale is None else \
        x * scale.reshape(scale.shape + (1,) * (x.ndim - 1))


def split_hi_lo(x: torch.Tensor):
    """x = hi + lo to 16 significant bits: hi = bf16(x), lo = bf16(x − hi),
    both rounded to nearest even, as the Hopper GEMM core's epilogue writes
    a float32 intermediate (two bf16 tensors, 4 bytes an element).  The
    difference x − hi is exact in fp32, so |hi + lo − x| ≤ 2⁻⁹·|x − hi| ≤
    2⁻¹⁸·|x| for normal x."""
    xf = x.float()
    hi = xf.to(torch.bfloat16)
    return hi, (xf - hi.float()).to(torch.bfloat16)


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


def smw_block_update_ref(j_inv: torch.Tensor, v: torch.Tensor,
                         gamma: float, variant: str = "paper",
                         n_valid=None) -> torch.Tensor:
    """Dense oracle for the block rank-r Woodbury update of one factor,
    written against the forward EMA target with an explicit r×r inverse.

    m = min(n_valid, r) chained rank-1 EMAs compose to
    γ^m J + Σ_{i<m} (1-γ)γ^(m-1-i) v_i v_iᵀ; ``exact_smw`` is that
    matrix's inverse via Woodbury, ``paper`` the PD-preserving
    generalization of Eq. 5/6 (positive rank-r term)."""
    r, _ = v.shape
    jf = j_inv.float()
    idx = torch.arange(r, dtype=torch.float32)
    m = torch.clamp(torch.tensor(float(r if n_valid is None else n_valid)),
                    max=float(r))
    w = torch.where(idx < m, (1.0 - gamma) * gamma ** torch.clamp(
        m - 1.0 - idx, min=0.0), torch.zeros(()))
    gm = gamma ** m
    vt = v.float() * torch.sqrt(w)[:, None]
    u = vt @ jf.T                               # rows (J⁻¹ṽ_i)ᵀ, J symmetric
    s = vt @ u.T
    eye = torch.eye(r, dtype=torch.float32)
    if variant == "paper":
        mid = torch.linalg.inv(gm ** 2 * eye + gm ** 3 * s)
        new = gm * jf + u.T @ mid @ u
    elif variant == "exact_smw":
        mid = torch.linalg.inv(gm * eye + s)
        new = (jf - u.T @ mid @ u) / gm
    else:
        raise ValueError(variant)
    return new.to(j_inv.dtype)


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


def smw_rank1_update_quant_ref(q: torch.Tensor, scale, v: torch.Tensor,
                               gamma: float,
                               variant: str = "paper") -> torch.Tensor:
    """Rank-1 SMW on an int8 factor: decode, then update (fp32)."""
    return smw_rank1_update_ref(dequant_ref(q, scale), v, gamma, variant)


def smw_block_update_quant_ref(q: torch.Tensor, scale, v: torch.Tensor,
                               gamma: float, variant: str = "paper",
                               n_valid=None) -> torch.Tensor:
    """Block rank-r Woodbury on an int8 factor (fp32 output)."""
    return smw_block_update_ref(dequant_ref(q, scale), v, gamma, variant,
                                n_valid=n_valid)


def fused_precondition_quant_ref(l_q: torch.Tensor, l_scale,
                                 r_q: torch.Tensor, r_scale,
                                 g_w: torch.Tensor,
                                 rescale: bool = True) -> torch.Tensor:
    """Precondition + rescale with both inverse factors int8."""
    return fused_precondition_ref(dequant_ref(l_q, l_scale),
                                  dequant_ref(r_q, r_scale), g_w,
                                  rescale=rescale)
