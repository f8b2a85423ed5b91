"""``fused_precond``: two-sided precondition + Frobenius rescale of a whole
factor bank (port of ``repro/kernels/precond.py::fused_precond``; CUDA
source ``csrc/precond.cu``, whose header gives the H100 design).

    ΔW = R⁻¹ G L⁻¹;  ΔW ← ΔW · ‖G‖_F / max(‖ΔW‖_F, 1e-30)   (per slice)

On CUDA tensors the first product runs through the port's ``matmul``
kernel into an fp32 scratch, and the ``precond`` kernel does the second
product with ΣΔ² fused into its epilogue, ΣG², and the in-place rescale.
The association is chosen so that the second product -- the one with a
float32 operand -- is the smaller: ``(R⁻¹G)L⁻¹`` when d_in > d_out, else
``R⁻¹(GL⁻¹)``.  Zero padding never arises (ragged dims are masked in the
kernel), so the reference's padding contract holds trivially.  CPU
tensors run :func:`fused_precond_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as mm

_DTYPES = (torch.bfloat16, torch.float32)


def rescale_update(delta: torch.Tensor, g_w: torch.Tensor,
                   n_lead: int = 0) -> torch.Tensor:
    """MKOR Alg. 1 line 10: match the raw gradient's Frobenius norm over
    every dim of a slice (all dims after the first ``n_lead``).  The
    ε = 1e-30 guard keeps an all-zero slice at zero instead of 0/0."""
    dims = tuple(range(n_lead, delta.ndim))
    gn = torch.sqrt(torch.sum(torch.square(g_w.float()), dim=dims,
                              keepdim=True))
    dn = torch.sqrt(torch.sum(torch.square(delta), dim=dims, keepdim=True))
    return delta * (gn / torch.clamp(dn, min=1e-30))


def fused_precond_plain(r_inv: torch.Tensor, g: torch.Tensor,
                        l_inv: torch.Tensor, *,
                        rescale: bool = True) -> torch.Tensor:
    """Plain version: r (B, di, di), g (B, di, do), l (B, do, do) → fp32."""
    delta = torch.matmul(torch.matmul(r_inv.float(), g.float()),
                         l_inv.float())
    return rescale_update(delta, g, n_lead=1) if rescale else delta


def fused_precond(r_inv: torch.Tensor, g: torch.Tensor, l_inv: torch.Tensor,
                  *, rescale: bool = True) -> torch.Tensor:
    """Batched ΔW = rescale(R⁻¹ G L⁻¹), fp32 out, one launch per bank."""
    if g.ndim != 3:
        raise ValueError(f"fused_precond: g must be (B, d_in, d_out), got "
                         f"{tuple(g.shape)}")
    b, d_in, d_out = g.shape
    if tuple(r_inv.shape) != (b, d_in, d_in) or \
            tuple(l_inv.shape) != (b, d_out, d_out):
        raise ValueError(f"fused_precond: r {tuple(r_inv.shape)}, g "
                         f"{tuple(g.shape)}, l {tuple(l_inv.shape)}")
    if g.device.type == "cpu":
        return fused_precond_plain(r_inv, g, l_inv, rescale=rescale)
    kernel = "fused_precond"
    build.check_tensor(g, "g", kernel, _DTYPES)
    build.check_tensor(r_inv, "r_inv", kernel, _DTYPES, device=g.device)
    build.check_tensor(l_inv, "l_inv", kernel, _DTYPES, device=g.device)
    out = torch.empty((b, d_in, d_out), dtype=torch.float32,
                      device=g.device)
    if out.numel() == 0:
        return out
    if d_out >= d_in:      # R⁻¹ (G L⁻¹): the fp32 operand is on the right
        p, q, k = r_inv, mm.matmul(g, l_inv), d_in
    else:                  # (R⁻¹ G) L⁻¹: the fp32 operand is on the left
        p, q, k = mm.matmul(r_inv, g), l_inv, d_out
    sums = torch.empty((2 * b,), dtype=torch.float32, device=g.device)
    vec_p = build.rows_aligned(p, k)
    vec_q = build.rows_aligned(q, d_out)
    lib = build.library("precond")
    with torch.cuda.device(g.device):
        err = lib.mkor_fused_precond(
            p.data_ptr(), q.data_ptr(), g.data_ptr(), out.data_ptr(),
            sums.data_ptr(), d_in, d_out, k, b,
            int(p.dtype == torch.float32), int(q.dtype == torch.float32),
            int(g.dtype == torch.float32), int(vec_p), int(vec_q),
            int(rescale), build.stream_handle(g.device))
    build.check(err, kernel)
    build.note_launch(kernel)
    return out
