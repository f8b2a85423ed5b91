"""``fused_smw``: the rank-1 SMW inverse update of a whole factor bank in
one kernel launch pair (port of ``repro/kernels/rank1_smw.py::fused_smw``;
CUDA source ``csrc/rank1_smw.cu``, whose header says how it maps onto the
H100).

    u = J v;  s = vᵀu;  J ← scale·J + coef(s)·u uᵀ     (per slice)

:func:`fused_smw` launches the kernel for CUDA tensors and raises on what
it does not take; for CPU tensors it runs :func:`fused_smw_plain`, the
plain PyTorch version of the same batched function (also the yardstick
``chip_smoke.py`` holds the kernel against on the card).  There is no
fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

VARIANTS = {"paper": 0, "exact_smw": 1}


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
                    variant: str = "paper") -> torch.Tensor:
    """Plain version: j (B, d, d), v (B, d) → (B, d, d) in j's dtype."""
    jf, vf = j.float(), v.float()
    u = torch.matmul(jf, vf[..., None])[..., 0]
    s = torch.sum(vf * u, dim=-1)
    scale, coef = smw_scale_coef(s, gamma, variant)
    new = scale * jf + coef[:, None, None] * (u[:, :, None] * u[:, None, :])
    return new.to(j.dtype)


def fused_smw(j: torch.Tensor, v: torch.Tensor, *, gamma: float,
              variant: str = "paper",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched rank-1 SMW update.  j: (B, d, d) bf16 or fp32, v: (B, d)
    fp32.  Returns the updated bank in j's dtype, written to ``out`` when
    given (``out`` may be ``j`` itself: the update is then in place)."""
    if j.ndim != 3 or j.shape[-1] != j.shape[-2] or v.shape != j.shape[:2]:
        raise ValueError(f"fused_smw: j {tuple(j.shape)} must be (B, d, d) "
                         f"and v {tuple(v.shape)} (B, d)")
    if variant not in VARIANTS:
        raise ValueError(f"fused_smw: unknown variant {variant!r}")
    if j.device.type == "cpu":
        new = fused_smw_plain(j, v, gamma=gamma, variant=variant)
        return new if out is None else out.copy_(new)
    kernel = "fused_smw"
    dtypes = (torch.bfloat16, torch.float32)
    build.check_tensor(j, "j", kernel, dtypes)
    build.check_tensor(v, "v", kernel, (torch.float32,), device=j.device)
    if out is None:
        out = torch.empty_like(j)
    build.check_tensor(out, "out", kernel, (j.dtype,), shape=j.shape,
                       device=j.device)
    b, d = j.shape[0], j.shape[-1]
    if b == 0 or d == 0:
        return out
    lib = build.library("rank1_smw")
    u = torch.empty((b, d), dtype=torch.float32, device=j.device)
    s_part = torch.empty((b, lib.mkor_smw_partials(d)), dtype=torch.float32,
                         device=j.device)
    vec = build.rows_aligned(j, d) and build.rows_aligned(out, d)
    with torch.cuda.device(j.device):
        err = lib.mkor_fused_smw(
            j.data_ptr(), v.data_ptr(), out.data_ptr(), u.data_ptr(),
            s_part.data_ptr(), d, b, int(j.dtype == torch.float32), int(vec),
            float(gamma), VARIANTS[variant], build.stream_handle(j.device))
    build.check(err, kernel)
    build.note_launch(kernel)
    return out
