"""The SMW kernels of MKOR's O(d²) factor update (port of
``repro/kernels/rank1_smw.py``; CUDA sources ``csrc/block_smw.cu`` and
``csrc/rank1_smw.cu``, whose headers say how each maps onto the H100):

* :func:`fused_smw` — the rank-1 update of a whole bank, per slice
  u = J v;  s = vᵀu;  J ← scale·J + coef(s)·u uᵀ.  It launches the block
  kernel at r = 1 with Ṽ = v, γ^m = γ and a row weight 1 − γ (the header
  of ``block_smw.cu`` shows the two forms agree).
* :func:`fused_block_smw` — the block rank-r Woodbury update of a whole
  bank, per slice U = JṼᵀ, S = ṼU, M = A(gm, S)⁻¹ and
  ``paper``: gm·J + U M Uᵀ (A = gm²I + gm³S) or
  ``exact_smw``: (J − U M Uᵀ)/gm (A = gm·I + S).
* :func:`matvec` (u = J v) and :func:`rank1_update` (J ← γJ + coef·uuᵀ),
  the reference's unfused building blocks, and :func:`smw_vectors` built
  on ``matvec`` as in the reference.

``fused_smw`` and ``fused_block_smw`` also take an int8 bank: the codes of
MKOR's int8 factor state with ``scale=`` its (B,) fp32 per-slice scales.
The kernels decode each code at its load and return the update in fp32
for the caller to requantize (the reference's ``scale=`` operand); these
launches count as ``fused_smw[int8]`` and ``fused_block_smw[int8]``.

Both run as one persistent launch whose blocks take runs of row tiles from
an in-order ticket counter; the kernel plans the tiles, the runs and how
far the writes trail pass 1 (``csrc/smw_plan.cuh``).

Each wrapper launches its kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain PyTorch version beside it
(``*_plain``, also the yardstick ``chip_smoke.py`` holds the kernel
against on the card).  There is no fallback from a CUDA tensor to the
plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dequant_ref

VARIANTS = {"paper": 0, "exact_smw": 1}


def _bank_kernel(name: str, j: torch.Tensor, scale, out, device):
    """Checks a bank and its optional int8 scales; returns the kernel's
    count name and the output (allocated when ``out`` is None): j's dtype,
    or fp32 for an int8 bank."""
    b = j.shape[0]
    if scale is None:
        build.check_tensor(j, "j", name, (torch.bfloat16, torch.float32))
        out_dtype = j.dtype
    else:
        name = f"{name}[int8]"
        build.check_tensor(j, "j", name, (torch.int8,))
        build.check_scale(scale, "scale", name, b, device)
        out_dtype = torch.float32
    if out is None:
        out = torch.empty(j.shape, dtype=out_dtype, device=device)
    build.check_tensor(out, "out", name, (out_dtype,), shape=j.shape,
                       device=device)
    return name, out


def smw_scale_coef(s: torch.Tensor, gamma: float, variant: str):
    """(scale, coef(s)) of Eq. 5/6 (paper) or the exact SMW form, fp32."""
    s = s.float()
    if variant == "paper":
        return gamma, (1.0 - gamma) / (
            gamma ** 2 * (1.0 + gamma * (1.0 - gamma) * s))
    if variant == "exact_smw":
        return 1.0 / gamma, -(1.0 - gamma) / (
            gamma * (gamma + (1.0 - gamma) * s))
    raise ValueError(variant)


def fused_smw_plain(j: torch.Tensor, v: torch.Tensor, *, gamma: float,
                    variant: str = "paper",
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: j (B, d, d), v (B, d) → (B, d, d) in j's dtype, or
    fp32 for int8 codes j with per-slice ``scale`` (B,) (decoded first)."""
    jf, vf = dequant_ref(j, scale), v.float()
    u = torch.matmul(jf, vf[..., None])[..., 0]
    s = torch.sum(vf * u, dim=-1)
    alpha, coef = smw_scale_coef(s, gamma, variant)
    new = alpha * jf + coef[:, None, None] * (u[:, :, None] * u[:, None, :])
    return new if scale is not None else new.to(j.dtype)


def fused_smw(j: torch.Tensor, v: torch.Tensor, *, gamma: float,
              variant: str = "paper", out: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched rank-1 SMW update.  j: (B, d, d) bf16 or fp32, or int8 codes
    with ``scale`` (B,) fp32; v: (B, d) fp32.  Returns the updated bank in
    j's dtype (fp32 for int8), written to ``out`` when given (``out`` may
    be ``j`` itself when the dtypes agree: the update is then in place)."""
    if j.ndim != 3 or j.shape[-1] != j.shape[-2] or v.shape != j.shape[:2]:
        raise ValueError(f"fused_smw: j {tuple(j.shape)} must be (B, d, d) "
                         f"and v {tuple(v.shape)} (B, d)")
    if variant not in VARIANTS:
        raise ValueError(f"fused_smw: unknown variant {variant!r}")
    if (scale is None) != (j.dtype != torch.int8):
        raise TypeError("fused_smw: an int8 bank needs its scale, and only "
                        "an int8 bank takes one")
    if j.device.type == "cpu":
        new = fused_smw_plain(j, v, gamma=gamma, variant=variant,
                              scale=scale)
        return new if out is None else out.copy_(new)
    kernel, out = _bank_kernel("fused_smw", j, scale, out, j.device)
    build.check_tensor(v, "v", kernel, (torch.float32,), device=j.device)
    b, d = j.shape[0], j.shape[-1]
    if b == 0 or d == 0:
        return out
    # the r = 1 block update: Ṽ = v, γ^m = γ on every slice, row weight 1 − γ
    with torch.cuda.device(j.device):
        _launch_block(kernel, j, v.view(b, 1, d), None, float(gamma),
                      1.0 - float(gamma), scale, out, None, 1, 1, variant)
    return out


# ----------------------------------------------------------------------- #
# Block rank-r Woodbury update
# ----------------------------------------------------------------------- #
BLOCK_RANKS = (1, 2, 4, 8, 16)   # kernel instances; r is padded up to one


def _bulk_rows(d: int, j: torch.Tensor, out: torch.Tensor,
               vt: torch.Tensor) -> bool:
    """The kernel's bulk path takes the bank: 16-byte rows of J and of the
    output on 16-byte bases (a tile's rows are one bulk copy, the output
    and Ṽ move in 4-element vectors)."""
    return build.rows_aligned(j, d) and build.rows_aligned(out, d) and \
        vt.data_ptr() % 16 == 0


def _launch_block(kernel, j, vt, gm, gm_all, vweight, scale, out, piv, rank,
                  r_real, variant):
    """One launch of the block kernel over the bank ``j`` (checked by the
    caller); ``gm`` None applies ``gm_all`` to every slice."""
    b, d = j.shape[0], j.shape[-1]
    lib = build.library("block_smw")
    work = torch.empty((lib.mkor_block_smw_work(d, b, rank,
                                                j.element_size()),),
                       dtype=torch.float32, device=j.device)
    sync = torch.zeros((1 + 2 * b,), dtype=torch.int32, device=j.device)
    err = lib.mkor_fused_block_smw(
        j.data_ptr(), vt.data_ptr(), build.ptr(gm), float(gm_all),
        float(vweight), build.ptr(scale), out.data_ptr(), work.data_ptr(),
        sync.data_ptr(), build.ptr(piv), d, b, rank, r_real,
        build.dtype_code(j), int(_bulk_rows(d, j, out, vt)), VARIANTS[variant],
        build.stream_handle(j.device))
    build.check(err, kernel)
    build.note_launch(kernel)


def solve_mid(mid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """mid⁻¹ u for the block update's r×r mid matrices (*lead, r, r) and
    rows u (*lead, r, d), from one LU factorization of ``mid`` with no host
    check of it (``lu_factor_ex``).  On the CPU the factors solve u
    directly, which is what ``torch.linalg.solve`` computes, bit for bit.
    On CUDA, ``lu_solve`` with d ≥ 256 right-hand sides reaches MAGMA's
    batched getrs, which a CUDA graph cannot hold, and ``solve``'s check
    of the factorization is a host sync; with r right-hand sides it runs
    cuBLAS's batched getrs, so the factors give mid⁻¹ and one product
    applies it (fp32 throughout; this rounds otherwise than the solve)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(mid)
    if mid.device.type != "cuda":
        return torch.linalg.lu_solve(lu, piv, u)
    eye = torch.eye(mid.shape[-1], dtype=mid.dtype, device=mid.device)
    return torch.matmul(torch.linalg.lu_solve(lu, piv, eye.expand_as(mid)),
                        u)


def fused_block_smw_plain(j: torch.Tensor, vt: torch.Tensor,
                          gm: torch.Tensor, *, variant: str = "paper",
                          with_pivot: bool = False,
                          scale: Optional[torch.Tensor] = None):
    """Plain version: j (*lead, d, d), vt (*lead, r, d) pre-weighted rows,
    gm broadcastable to ``lead`` → the update in j's dtype, computed in
    fp32 with :func:`solve_mid` for the mid matrix (``torch.linalg.solve``
    on the CPU), as the reference's ``core.mkor.smw_block_update``.
    int8 codes j with per-slice ``scale`` (``lead``) are decoded first and
    the update comes back fp32.
    ``with_pivot`` also returns, per slice, the smallest squared Cholesky
    diagonal entry of the mid matrix (NaN where it is not positive
    definite), the reference's pivot."""
    jf, vf = dequant_ref(j, scale), vt.float()
    r = vf.shape[-2]
    g = torch.as_tensor(gm, dtype=torch.float32,
                        device=jf.device)[..., None, None]
    u = torch.matmul(vf, jf.transpose(-1, -2))          # rows (J ṽ_i)ᵀ
    s = torch.matmul(vf, u.transpose(-1, -2))           # ṼJṼᵀ (r, r)
    eye = torch.eye(r, dtype=torch.float32, device=jf.device)
    if variant == "paper":
        mid = g * g * eye + g * g * g * s
        new = g * jf + torch.matmul(u.transpose(-1, -2), solve_mid(mid, u))
    elif variant == "exact_smw":
        mid = g * eye + s
        new = (jf - torch.matmul(u.transpose(-1, -2),
                                 solve_mid(mid, u))) / g
    else:
        raise ValueError(variant)
    if scale is None:
        new = new.to(j.dtype)
    if not with_pivot:
        return new
    chol, info = torch.linalg.cholesky_ex(mid)
    piv = torch.amin(torch.diagonal(chol, dim1=-2, dim2=-1) ** 2, dim=-1)
    return new, torch.where(info == 0, piv, torch.full_like(piv, math.nan))


def fused_block_smw(j: torch.Tensor, vt: torch.Tensor, gm: torch.Tensor, *,
                    variant: str = "paper", with_pivot: bool = False,
                    out: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None):
    """Batched block rank-r Woodbury update.  j: (B, d, d) bf16 or fp32, or
    int8 codes with ``scale`` (B,) fp32; vt: (B, r, d) fp32 window rows
    pre-weighted by √wᵢ; gm: (B,) fp32, the per-slice γ^m.  Returns the
    updated bank in j's dtype (fp32 for int8), written to ``out`` when
    given (``out`` may be ``j`` when the dtypes agree: the update is then
    in place).

    ``with_pivot=True`` returns ``(new, pivot)`` with pivot (B,) fp32: the
    smallest pivot of the kernel's unpivoted Gauss–Jordan elimination of
    the r×r mid matrix over the r real rows, which for a positive definite
    mid matrix equals the smallest squared Cholesky diagonal entry that
    ``repro.core.mkor.smw_block_update(with_pivot=True)`` returns for each
    slice; NaN where a pivot is not positive or not finite (where that
    Cholesky fails).  The reference's fused entry pads r to a multiple of
    8, and its zero rows add pivots of gm² or gm (the paper and exact
    variants) to its min; the kernel's padding rows are left out.  The
    sentinel's trip, ``pivot >= health_pivot_tol`` false, comes out the
    same at the default tolerance 1e-12, since γ^m and γ^2m stay far above
    it.  Without it nothing is computed or written for the pivot."""
    if j.ndim != 3 or j.shape[-1] != j.shape[-2] or vt.ndim != 3 or \
            vt.shape[0] != j.shape[0] or vt.shape[-1] != j.shape[-1] or \
            tuple(gm.shape) != (j.shape[0],):
        raise ValueError(f"fused_block_smw: j {tuple(j.shape)} must be "
                         f"(B, d, d), vt {tuple(vt.shape)} (B, r, d) and gm "
                         f"{tuple(gm.shape)} (B,)")
    if variant not in VARIANTS:
        raise ValueError(f"fused_block_smw: unknown variant {variant!r}")
    if (scale is None) != (j.dtype != torch.int8):
        raise TypeError("fused_block_smw: an int8 bank needs its scale, "
                        "and only an int8 bank takes one")
    if j.device.type == "cpu":
        res = fused_block_smw_plain(j, vt, gm, variant=variant,
                                    with_pivot=with_pivot, scale=scale)
        if out is None:
            return res
        if with_pivot:
            return out.copy_(res[0]), res[1]
        return out.copy_(res)
    kernel, out = _bank_kernel("fused_block_smw", j, scale, out, j.device)
    build.check_tensor(vt, "vt", kernel, (torch.float32,), device=j.device)
    build.check_tensor(gm, "gm", kernel, (torch.float32,), device=j.device)
    b, r, d = vt.shape
    rank = next((k for k in BLOCK_RANKS if k >= r), None)
    if rank is None:
        raise ValueError(f"fused_block_smw: rank {r} > {BLOCK_RANKS[-1]} "
                         "is not built")
    piv = torch.empty((b,), dtype=torch.float32, device=j.device) \
        if with_pivot else None
    if b == 0 or d == 0:
        return (out, piv) if with_pivot else out
    if rank != r:                       # zero rows are inert (header note)
        vt = torch.cat([vt, vt.new_zeros((b, rank - r, d))], dim=1)
    with torch.cuda.device(j.device):
        _launch_block(kernel, j, vt, gm, 1.0, 1.0, scale, out, piv, rank, r,
                      variant)
    return (out, piv) if with_pivot else out


# ----------------------------------------------------------------------- #
# The unfused building blocks: matvec and rank1_update
# ----------------------------------------------------------------------- #
def _check_square(j, vec, kernel):
    d = j.shape[-1]
    if j.ndim != 2 or j.shape[0] != d or tuple(vec.shape) != (d, 1):
        raise ValueError(f"{kernel}: j {tuple(j.shape)} must be (d, d) and "
                         f"the vector {tuple(vec.shape)} (d, 1)")
    return d


def matvec_plain(j: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: u = J v in fp32.  j (d, d), v (d, 1) → (d, 1)."""
    return torch.matmul(j.float(), v.float())


def matvec(j: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u = J v with fp32 accumulation.  j: (d, d) bf16 or fp32; v: (d, 1)
    fp32 → u (d, 1) fp32."""
    d = _check_square(j, v, "matvec")
    if j.device.type == "cpu":
        return matvec_plain(j, v)
    kernel = "matvec"
    build.check_tensor(j, "j", kernel, (torch.bfloat16, torch.float32))
    build.check_tensor(v, "v", kernel, (torch.float32,), device=j.device)
    u = torch.empty((d, 1), dtype=torch.float32, device=j.device)
    if d == 0:
        return u
    lib = build.library("rank1_smw")
    with torch.cuda.device(j.device):
        err = lib.mkor_matvec(j.data_ptr(), v.data_ptr(), u.data_ptr(), d, 1,
                              int(j.dtype == torch.float32),
                              int(build.rows_aligned(j, d)),
                              build.stream_handle(j.device))
    build.check(err, kernel)
    build.note_launch(kernel)
    return u


def smw_vectors(j: torch.Tensor, v: torch.Tensor):
    """(u, s) = (J v, vᵀ J v): the ``matvec`` kernel, then s = vᵀu."""
    u = matvec(j, v)
    return u, torch.sum(v[:, 0].float() * u[:, 0])


def rank1_update_plain(j: torch.Tensor, u: torch.Tensor, coef, *,
                       gamma: float) -> torch.Tensor:
    """Plain version: γJ + coef·uuᵀ in fp32, returned in j's dtype."""
    uf = u.float()
    c = torch.as_tensor(coef, dtype=torch.float32, device=j.device)
    return (gamma * j.float() + c.reshape(()) * (uf @ uf.T)).to(j.dtype)


def rank1_update(j: torch.Tensor, u: torch.Tensor, coef: torch.Tensor, *,
                 gamma: float,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """J ← γJ + coef·uuᵀ without forming uuᵀ.  j: (d, d) bf16 or fp32;
    u: (d, 1) fp32; coef: a one-element fp32 tensor on j's device (read
    there by the kernel, no host sync).  Returns j's dtype, written to
    ``out`` when given (``out`` may be ``j``)."""
    d = _check_square(j, u, "rank1_update")
    if coef.numel() != 1:
        raise ValueError(f"rank1_update: coef {tuple(coef.shape)} must hold "
                         "one value")
    if j.device.type == "cpu":
        new = rank1_update_plain(j, u, coef, gamma=gamma)
        return new if out is None else out.copy_(new)
    kernel = "rank1_update"
    build.check_tensor(j, "j", kernel, (torch.bfloat16, torch.float32))
    build.check_tensor(u, "u", kernel, (torch.float32,), device=j.device)
    build.check_tensor(coef, "coef", kernel, (torch.float32,),
                       device=j.device)
    if out is None:
        out = torch.empty_like(j)
    build.check_tensor(out, "out", kernel, (j.dtype,), shape=j.shape,
                       device=j.device)
    if d == 0:
        return out
    lib = build.library("rank1_smw")
    vec = build.rows_aligned(j, d) and build.rows_aligned(out, d)
    with torch.cuda.device(j.device):
        err = lib.mkor_rank1_update(
            j.data_ptr(), out.data_ptr(), u.data_ptr(), coef.data_ptr(), d,
            1, int(j.dtype == torch.float32), int(vec), float(gamma),
            build.stream_handle(j.device))
    build.check(err, kernel)
    build.note_launch(kernel)
    return out
