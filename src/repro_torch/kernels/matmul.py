"""``matmul``: batched (M, K) @ (K, N) with an fp32 accumulator (port of
``repro/kernels/matmul.py::matmul``; CUDA source ``csrc/matmul.cu``).

Operands are 2-D or 3-D; a 2-D operand broadcasts over the other's batch.
bf16 and fp32 inputs are taken, and int8 codes with their (B,) per-slice
fp32 scales (``a_scale=`` / ``b_scale=``, a 3-D operand and an fp32
output): the codes enter the tensor cores exactly and the scale multiplies
the product in the epilogue, so no decoded copy is made (the first product
of ``fused_precond`` on int8 factor banks).  CUDA tensors launch a kernel;
CPU tensors run :func:`matmul_plain`.

Two GEMM cores, and :func:`gemm_route` picks one before the launch from
dtypes, shape and alignment alone: bf16 operands, or one operand of int8
codes, with 16-byte-aligned bases and rows and batch strides of a multiple
of 16 bytes go to the Hopper core (``csrc/wgmma_gemm.cuh``: TMA ring +
``wgmma``; int8 codes are widened to bf16 in shared memory); everything
else -- fp32 operands (which ride the tensor cores as bf16 hi/lo pairs),
ragged row widths -- to the WMMA core (``csrc/gemm.cuh``).  ``core=``
forces one (measurement and tests); forcing ``"wgmma"`` on operands it
does not take raises.  :func:`matmul_split` returns the product as a bf16
hi/lo pair, the first product of ``fused_precond`` on the Hopper core.
Launches with an int8 operand count as ``matmul[int8 operand]``, the
others as ``matmul``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dequant_ref, scale_slices, split_hi_lo

_DTYPES = (torch.bfloat16, torch.float32)
CORES = (None,) + build.GEMM_CORES
# the elements in TMA's 16-byte unit, for the dtypes the Hopper core loads
_TMA_UNIT = {torch.bfloat16: 8, torch.int8: 16}


def _tma_operand(dtype: torch.dtype, row: int, addr: int,
                 batch_stride: int) -> bool:
    unit = _TMA_UNIT.get(dtype)
    return (unit is not None and row % unit == 0 and addr % 16 == 0
            and batch_stride % unit == 0)


def gemm_route(a_dtype: torch.dtype, b_dtype: torch.dtype, k: int, n: int,
               a_addr: int, b_addr: int, a_batch_stride: int = 0,
               b_batch_stride: int = 0) -> str:
    """The core that runs A (.., M, K) @ B (.., K, N), both row-major:
    ``"wgmma"`` when TMA can load both operands -- bf16 (a hi/lo pair is
    two bf16 tensors), or int8 codes in at most one of them, with
    16-byte-aligned base addresses, and rows (K for A, N for B) and batch
    strides (elements; 0 broadcasts a 2-D operand, which takes a 2-D
    tensor map) that are multiples of 16 bytes: 8 bf16 values, 16 codes --
    else ``"wmma"``.  M never matters: TMA zero-fills a ragged tile edge
    within its slice."""
    if a_dtype == b_dtype == torch.int8:
        return "wmma"
    if _tma_operand(a_dtype, k, a_addr, a_batch_stride) and \
            _tma_operand(b_dtype, n, b_addr, b_batch_stride):
        return "wgmma"
    return "wmma"


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=torch.float32, *,
                 a_scale: Optional[torch.Tensor] = None,
                 b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.matmul(dequant_ref(a, a_scale),
                        dequant_ref(b, b_scale)).to(out_dtype)


def _kernel_name(a, b) -> str:
    return "matmul[int8 operand]" if torch.int8 in (a.dtype, b.dtype) \
        else "matmul"


def _check_shapes(a, b, a_scale, b_scale, out_dtype, core):
    if core not in CORES:
        raise ValueError(f"matmul: core {core!r} not in {CORES}")
    if a.ndim not in (2, 3) or b.ndim not in (2, 3) or \
            a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.ndim == 3 and b.ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"matmul: batch {a.shape[0]} != {b.shape[0]}")
    for x, sc, name in ((a, a_scale, "a"), (b, b_scale, "b")):
        if (sc is None) != (x.dtype != torch.int8):
            raise TypeError(f"matmul: an int8 {name} needs its scale, and "
                            "only an int8 operand takes one")
        if sc is not None and (x.ndim != 3 or out_dtype != torch.float32):
            raise ValueError(f"matmul: an int8 {name} must be 3-D with an "
                             "fp32 output")


def _geometry(a, b):
    """(m, k, n, batch, batch stride of a, batch stride of b)."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    batch = a.shape[0] if a.ndim == 3 else (b.shape[0] if b.ndim == 3 else 1)
    sa = m * k if a.ndim == 3 else 0
    sb = k * n if b.ndim == 3 else 0
    return m, k, n, batch, sa, sb


def route_of(a: torch.Tensor, b: torch.Tensor) -> str:
    """:func:`gemm_route` for two tensors as :func:`matmul` lays them out."""
    _, k, n, _, sa, sb = _geometry(a, b)
    return gemm_route(a.dtype, b.dtype, k, n, a.data_ptr(), b.data_ptr(),
                      sa, sb)


def _pick_core(a, b, core, kernel):
    route = route_of(a, b)
    if core == "wgmma" and route != "wgmma":
        raise ValueError(f"{kernel}: the wgmma core takes bf16 operands, "
                         "or one of int8 codes, with 16-byte-aligned bases "
                         "and rows; got "
                         f"{a.dtype} {tuple(a.shape)} @ {b.dtype} "
                         f"{tuple(b.shape)}")
    return core or route


def _launch_tma(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                out_lo: Optional[torch.Tensor] = None,
                a_scale: Optional[torch.Tensor] = None,
                b_scale: Optional[torch.Tensor] = None) -> None:
    """``mkor_matmul_tma`` into ``out`` (fp32, or bf16 hi with ``out_lo``
    its bf16 lo part or None), an int8 operand with its scale; counts one
    ``wgmma`` GEMM."""
    m, k, n, batch, sa, sb = _geometry(a, b)
    lib = build.library("matmul")
    with torch.cuda.device(a.device):
        err = lib.mkor_matmul_tma(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), build.ptr(out_lo),
            build.ptr(a_scale), build.ptr(b_scale), m, n, k, sa, sb, batch,
            int(out.dtype == torch.bfloat16), build.stream_handle(a.device))
    build.check(err, _kernel_name(a, b))
    build.note_gemm("wgmma")


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.float32,
           a_scale: Optional[torch.Tensor] = None,
           b_scale: Optional[torch.Tensor] = None,
           core: Optional[str] = None) -> torch.Tensor:
    _check_shapes(a, b, a_scale, b_scale, out_dtype, core)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, out_dtype, a_scale=a_scale,
                            b_scale=b_scale)
    kernel = _kernel_name(a, b)
    build.check_tensor(a, "a", kernel, _DTYPES + (torch.int8,))
    build.check_tensor(b, "b", kernel, _DTYPES + (torch.int8,),
                       device=a.device)
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        raise TypeError("matmul: at most one int8 operand")
    if out_dtype not in _DTYPES:
        raise TypeError(f"matmul: out_dtype {out_dtype} not in {_DTYPES}")
    m, k, n, batch, sa, sb = _geometry(a, b)
    for x, sc, name in ((a, a_scale, "a_scale"), (b, b_scale, "b_scale")):
        if sc is not None:
            build.check_scale(sc, name, kernel, batch, a.device)
    squeeze = a.ndim == 2 and b.ndim == 2
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    if batch == 0 or m == 0 or n == 0:
        return out[0] if squeeze else out
    if k == 0:
        return out.zero_()[0] if squeeze else out.zero_()
    if _pick_core(a, b, core, kernel) == "wgmma":
        _launch_tma(a, b, out, a_scale=a_scale, b_scale=b_scale)
        build.note_launch(kernel)
        return out[0] if squeeze else out
    vec_a = build.rows_aligned(a, k) and (sa * a.element_size()) % 16 == 0
    vec_b = build.rows_aligned(b, n) and (sb * b.element_size()) % 16 == 0
    lib = build.library("matmul")
    with torch.cuda.device(a.device):
        err = lib.mkor_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), build.ptr(a_scale),
            build.ptr(b_scale), m, n, k, k, n,
            n, sa, sb, m * n, batch, build.dtype_code(a),
            build.dtype_code(b), int(out_dtype == torch.float32),
            int(vec_a), int(vec_b), build.stream_handle(a.device))
    build.check(err, kernel)
    build.note_gemm("wmma")
    build.note_launch(kernel)
    return out[0] if squeeze else out


def matmul_split(a: torch.Tensor, b: torch.Tensor, *,
                 a_scale: Optional[torch.Tensor] = None,
                 b_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A @ B (3-D, or 2-D broadcast) as a bf16 pair (hi, lo) with
    hi = bf16(c), lo = bf16(c − hi) of the fp32 product c, each
    (batch, M, N): the fp32 intermediate of ``fused_precond`` in the form
    the Hopper core loads by TMA.  One operand may be int8 codes with its
    (B,) scale (``a_scale=`` / ``b_scale=``): c is then the scaled product,
    split after the scale.  Only the ``wgmma`` route writes it; CPU tensors
    run ``split_hi_lo`` of the same fp32 arithmetic (:func:`matmul_plain`
    for bf16 operands)."""
    _check_shapes(a, b, a_scale, b_scale, torch.float32, None)
    if a.device.type == "cpu" and b.device.type == "cpu":
        # the Hopper core's arithmetic: the codes widened exactly, the
        # product, then the int8 operand's scale (bf16 operands:
        # matmul_plain's fp32 product)
        c = torch.matmul(a.float(), b.float())
        c = scale_slices(scale_slices(c, a_scale), b_scale)
        return split_hi_lo(c if c.ndim == 3 else c[None])
    kernel = _kernel_name(a, b)
    dtypes = (torch.bfloat16, torch.int8)
    build.check_tensor(a, "a", kernel, dtypes)
    build.check_tensor(b, "b", kernel, dtypes, device=a.device)
    m, k, n, batch, _, _ = _geometry(a, b)
    for sc, name in ((a_scale, "a_scale"), (b_scale, "b_scale")):
        if sc is not None:
            build.check_scale(sc, name, kernel, batch, a.device)
    hi = torch.empty((batch, m, n), dtype=torch.bfloat16, device=a.device)
    lo = torch.empty_like(hi)
    if hi.numel() == 0:
        return hi, lo
    if k == 0:
        return hi.zero_(), lo.zero_()
    _pick_core(a, b, "wgmma", kernel)
    _launch_tma(a, b, hi, lo, a_scale, b_scale)
    build.note_launch(kernel)
    return hi, lo
