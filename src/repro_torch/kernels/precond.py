"""``fused_precond``: two-sided precondition + Frobenius rescale of a whole
factor bank (port of ``repro/kernels/precond.py::fused_precond``; CUDA
source ``csrc/precond.cu``, whose header gives the H100 design).

    ΔW = R⁻¹ G L⁻¹;  ΔW ← ΔW · ‖G‖_F / max(‖ΔW‖_F, 1e-30)   (per slice)

On CUDA tensors the first product runs through the port's ``matmul``
kernel into device scratch, and the ``precond`` kernel does the second
product with ΣΔ² fused into its epilogue, ΣG², and the in-place rescale.
ΣG² and ΣΔ² are partial sums written to scratch and added in a fixed
order, so a second call on the same inputs gives the same bits.
The association is chosen so that the second product -- the one with the
float32 intermediate T -- is the smaller: ``(R⁻¹G)L⁻¹`` when
d_in > d_out, else ``R⁻¹(GL⁻¹)``.  Zero padding never arises (ragged dims
are masked or zero-filled in the kernels), so the reference's padding
contract holds trivially.  CPU tensors run :func:`fused_precond_plain`.

:func:`precond_route` picks the GEMM core before the launch.  On the
Hopper core (``"wgmma"``: bf16 G, bf16 or int8 R and L, rows of a multiple
of 16 bytes -- every bert-large shape) the first product writes T as a
bf16 hi/lo pair (``matmul_split``) and the second runs ``T_hi·F + T_lo·F``
in one accumulator (:func:`fused_precond_split_plain` states that
arithmetic); elsewhere (``"wmma"``) T is fp32 scratch, split on its way
into the tensor cores.  The two are the same operands and the same
tolerance.

int8 factor banks (MKOR's int8 factor state) come as codes with
``r_scale=`` / ``l_scale=``, their (B,) fp32 per-slice scales, both or
neither.  Both products take the codes directly (widened exactly to bf16
in shared memory on the Hopper core, exact bf16 parts on the WMMA core)
and apply the scale of their int8 operand to the accumulator in the
epilogue, before the hi/lo split of T and before the sum of squares: no
decoded copy of a bank is made.  These launches count as
``fused_precond[int8]``, their first products as ``matmul[int8 operand]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as mm
from repro_torch.kernels.ref import dequant_ref, scale_slices, split_hi_lo

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
                        l_inv: torch.Tensor, *, rescale: bool = True,
                        r_scale: Optional[torch.Tensor] = None,
                        l_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version: r (B, di, di), g (B, di, do), l (B, do, do) → fp32;
    int8 factors with their (B,) scales are decoded first."""
    r, l = dequant_ref(r_inv, r_scale), dequant_ref(l_inv, l_scale)
    delta = torch.matmul(torch.matmul(r, g.float()), l)
    return rescale_update(delta, g, n_lead=1) if rescale else delta


def fused_precond_split_plain(r_inv: torch.Tensor, g: torch.Tensor,
                              l_inv: torch.Tensor, *, rescale: bool = True,
                              r_scale: Optional[torch.Tensor] = None,
                              l_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The Hopper route's arithmetic in fp32: the first product split into
    a bf16 pair T = hi + lo (``split_hi_lo``), the second as
    (T_hi @ F) + (T_lo @ F), in the kernel's association.  int8 factors:
    the codes widened exactly, each product's scale applied to its
    accumulator -- the first one's before the split."""
    r, gf, l = r_inv.float(), g.float(), l_inv.float()
    if g.shape[-1] >= g.shape[-2]:      # R⁻¹ (G L⁻¹)
        hi, lo = split_hi_lo(scale_slices(torch.matmul(gf, l), l_scale))
        delta = scale_slices(torch.matmul(r, hi.float())
                             + torch.matmul(r, lo.float()), r_scale)
    else:                               # (R⁻¹ G) L⁻¹
        hi, lo = split_hi_lo(scale_slices(torch.matmul(r, gf), r_scale))
        delta = scale_slices(torch.matmul(hi.float(), l)
                             + torch.matmul(lo.float(), l), l_scale)
    return rescale_update(delta, g, n_lead=1) if rescale else delta


def precond_route(r_dtype: torch.dtype, g_dtype: torch.dtype,
                  l_dtype: torch.dtype, d_in: int, d_out: int, r_addr: int,
                  g_addr: int, l_addr: int) -> str:
    """The core of both products (``mm.gemm_route`` of each; T is a fresh,
    aligned bf16 pair): ``"wgmma"`` only when both go there."""
    bf = torch.bfloat16
    if d_out >= d_in:       # first G L⁻¹, then R⁻¹ T
        first = mm.gemm_route(g_dtype, l_dtype, d_out, d_out, g_addr,
                              l_addr, d_in * d_out, d_out * d_out)
        second = mm.gemm_route(r_dtype, bf, d_in, d_out, r_addr, 0,
                               d_in * d_in, d_in * d_out)
    else:                   # first R⁻¹ G, then T L⁻¹
        first = mm.gemm_route(r_dtype, g_dtype, d_in, d_out, r_addr, g_addr,
                              d_in * d_in, d_in * d_out)
        second = mm.gemm_route(bf, l_dtype, d_out, d_out, 0, l_addr,
                               d_in * d_out, d_out * d_out)
    return "wgmma" if first == second == "wgmma" else "wmma"


def scratch_floats(lib, m: int, n: int, batch: int, *, tma: bool = False,
                   quant: bool = False) -> int:
    """Floats of fp32 scratch one launch takes: the sums and their
    partial-sum slots, as many as the C entry point says its tiles write.
    On the wgmma core (``tma``) the first product crosses as a bf16 hi/lo
    pair, the left operand of the second product when n < m; an int8 L⁻¹
    (``quant``) is then its right operand."""
    p_split = tma and n < m
    return lib.mkor_fused_precond_scratch(m, n, batch, int(tma),
                                          int(p_split), int(p_split and quant))


def _scratch(lib, m: int, n: int, batch: int, device, *, tma=False,
             quant=False) -> torch.Tensor:
    return torch.empty((scratch_floats(lib, m, n, batch, tma=tma,
                                       quant=quant),),
                       dtype=torch.float32, device=device)


def fused_precond(r_inv: torch.Tensor, g: torch.Tensor, l_inv: torch.Tensor,
                  *, rescale: bool = True,
                  r_scale: Optional[torch.Tensor] = None,
                  l_scale: Optional[torch.Tensor] = None,
                  core: Optional[str] = None) -> torch.Tensor:
    """Batched ΔW = rescale(R⁻¹ G L⁻¹), fp32 out, one launch per bank.
    int8 factors take their per-slice ``r_scale`` / ``l_scale`` (B,).
    ``core`` forces the GEMM core of both products (default: the route)."""
    if core not in mm.CORES:
        raise ValueError(f"fused_precond: core {core!r} not in {mm.CORES}")
    if g.ndim != 3:
        raise ValueError(f"fused_precond: g must be (B, d_in, d_out), got "
                         f"{tuple(g.shape)}")
    b, d_in, d_out = g.shape
    if tuple(r_inv.shape) != (b, d_in, d_in) or \
            tuple(l_inv.shape) != (b, d_out, d_out):
        raise ValueError(f"fused_precond: r {tuple(r_inv.shape)}, g "
                         f"{tuple(g.shape)}, l {tuple(l_inv.shape)}")
    quant = r_scale is not None
    if (l_scale is not None) != quant:
        raise ValueError("fused_precond: int8 factors need both scales")
    if quant != (r_inv.dtype == torch.int8) or \
            quant != (l_inv.dtype == torch.int8):
        raise TypeError(f"fused_precond: factors {r_inv.dtype} / "
                        f"{l_inv.dtype}; int8 factors need their scales, "
                        "and only int8 factors take them")
    fdtypes = (torch.int8,) if quant else _DTYPES
    if g.device.type == "cpu":
        return fused_precond_plain(r_inv, g, l_inv, rescale=rescale,
                                   r_scale=r_scale, l_scale=l_scale)
    kernel = "fused_precond[int8]" if quant else "fused_precond"
    build.check_tensor(g, "g", kernel, _DTYPES)
    build.check_tensor(r_inv, "r_inv", kernel, fdtypes, device=g.device)
    build.check_tensor(l_inv, "l_inv", kernel, fdtypes, device=g.device)
    if quant:
        build.check_scale(r_scale, "r_scale", kernel, b, g.device)
        build.check_scale(l_scale, "l_scale", kernel, b, g.device)
    out = torch.empty((b, d_in, d_out), dtype=torch.float32,
                      device=g.device)
    if out.numel() == 0:
        return out
    route = precond_route(r_inv.dtype, g.dtype, l_inv.dtype, d_in, d_out,
                          r_inv.data_ptr(), g.data_ptr(), l_inv.data_ptr())
    if core == "wgmma" and route != "wgmma":
        raise ValueError("fused_precond: the wgmma core takes bf16 G and "
                         "bf16 or int8 R and L with 16-byte-aligned bases "
                         "and rows; got "
                         f"{r_inv.dtype} / {g.dtype} / {l_inv.dtype}, "
                         f"d_in {d_in}, d_out {d_out}")
    lib = build.library("precond")
    if (core or route) == "wgmma":
        # T as a bf16 hi/lo pair (of the scaled product for an int8
        # factor); the second product takes both parts and the other
        # factor, with its scale
        if d_out >= d_in:  # R⁻¹ (G L⁻¹): the pair is on the right
            (p, p_lo), (q, q_lo) = (r_inv, None), mm.matmul_split(
                g, l_inv, b_scale=l_scale)
            k, p_scale, q_scale = d_in, r_scale, None
        else:              # (R⁻¹ G) L⁻¹: the pair is on the left
            (p, p_lo), (q, q_lo) = mm.matmul_split(
                r_inv, g, a_scale=r_scale), (l_inv, None)
            k, p_scale, q_scale = d_out, None, l_scale
        scratch = _scratch(lib, d_in, d_out, b, g.device, tma=True,
                           quant=quant)
        with torch.cuda.device(g.device):
            err = lib.mkor_fused_precond_tma(
                p.data_ptr(), build.ptr(p_lo), q.data_ptr(), build.ptr(q_lo),
                g.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                build.ptr(p_scale), build.ptr(q_scale), d_in, d_out, k, b,
                int(g.dtype == torch.float32), int(rescale),
                build.stream_handle(g.device))
        build.check(err, kernel)
        build.note_gemm("wgmma")
        build.note_launch(kernel)
        return out
    # the scale of the int8 factor in the second product (p or q)
    if d_out >= d_in:      # R⁻¹ (G L⁻¹): the fp32 operand is on the right
        p, k = r_inv, d_in
        q = mm.matmul(g, l_inv, b_scale=l_scale, core="wmma")
        p_scale, q_scale = r_scale, None
    else:                  # (R⁻¹ G) L⁻¹: the fp32 operand is on the left
        p = mm.matmul(r_inv, g, a_scale=r_scale, core="wmma")
        q, k = l_inv, d_out
        p_scale, q_scale = None, l_scale
    vec_p = build.rows_aligned(p, k)
    vec_q = build.rows_aligned(q, d_out)
    scratch = _scratch(lib, d_in, d_out, b, g.device)
    with torch.cuda.device(g.device):
        err = lib.mkor_fused_precond(
            p.data_ptr(), q.data_ptr(), g.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), build.ptr(p_scale), build.ptr(q_scale), d_in,
            d_out, k, b, build.dtype_code(p), build.dtype_code(q),
            int(g.dtype == torch.float32), int(vec_p), int(vec_q),
            int(rescale), build.stream_handle(g.device))
    build.check(err, kernel)
    build.note_gemm("wmma")
    build.note_launch(kernel)
    return out
