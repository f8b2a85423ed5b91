"""``matmul``: batched (M, K) @ (K, N) with an fp32 accumulator (port of
``repro/kernels/matmul.py::matmul``; CUDA source ``csrc/matmul.cu`` on the
tensor cores, ``csrc/gemm.cuh``).

Operands are 2-D or 3-D; a 2-D operand broadcasts over the other's batch.
bf16 and fp32 inputs are taken (fp32 ones ride the tensor cores as bf16
hi/lo pairs, keeping 16 significant bits), and int8 codes with their (B,)
per-slice fp32 scales (``a_scale=`` / ``b_scale=``, a 3-D operand and an
fp32 output): the codes enter the tensor cores exactly and the scale
multiplies the product in the epilogue, so no decoded copy is made (the
first product of ``fused_precond`` on int8 factor banks).  CUDA tensors
launch the kernel; CPU tensors run :func:`matmul_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dequant_ref

_DTYPES = (torch.bfloat16, torch.float32)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=torch.float32, *,
                 a_scale: Optional[torch.Tensor] = None,
                 b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.matmul(dequant_ref(a, a_scale),
                        dequant_ref(b, b_scale)).to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.float32,
           a_scale: Optional[torch.Tensor] = None,
           b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, out_dtype, a_scale=a_scale,
                            b_scale=b_scale)
    kernel = "matmul"
    build.check_tensor(a, "a", kernel, _DTYPES + (torch.int8,))
    build.check_tensor(b, "b", kernel, _DTYPES + (torch.int8,),
                       device=a.device)
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        raise TypeError("matmul: at most one int8 operand")
    if out_dtype not in _DTYPES:
        raise TypeError(f"matmul: out_dtype {out_dtype} not in {_DTYPES}")
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    batch = a.shape[0] if a.ndim == 3 else (b.shape[0] if b.ndim == 3 else 1)
    for x, sc, name in ((a, a_scale, "a_scale"), (b, b_scale, "b_scale")):
        if sc is not None:
            build.check_scale(sc, name, kernel, batch, a.device)
    squeeze = a.ndim == 2 and b.ndim == 2
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    if batch == 0 or m == 0 or n == 0:
        return out[0] if squeeze else out
    if k == 0:
        return out.zero_()[0] if squeeze else out.zero_()
    sa = m * k if a.ndim == 3 else 0
    sb = k * n if b.ndim == 3 else 0
    vec_a = build.rows_aligned(a, k) and (sa * a.element_size()) % 16 == 0
    vec_b = build.rows_aligned(b, n) and (sb * b.element_size()) % 16 == 0
    lib = build.library("matmul")
    with torch.cuda.device(a.device):
        err = lib.mkor_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if a_scale is None else a_scale.data_ptr(),
            None if b_scale is None else b_scale.data_ptr(), m, n, k, k, n,
            n, sa, sb, m * n, batch, build.dtype_code(a),
            build.dtype_code(b), int(out_dtype == torch.float32),
            int(vec_a), int(vec_b), build.stream_handle(a.device))
    build.check(err, kernel)
    build.note_launch(kernel)
    return out[0] if squeeze else out
