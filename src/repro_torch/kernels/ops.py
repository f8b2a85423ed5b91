"""Banked entry points to the kernels and the launch / fallback counters
(port of ``repro/kernels/ops.py``).  These are what MKOR calls with
``MKORConfig.use_kernels=True``.

Contract, as in the reference: a bank is ``(*lead, d, d)`` with
``lead = (n_bucket_layers, *stack)``; the lead dims are flattened and each
banked entry makes ONE launch per bucket, with the flattened lead dims as
the kernel's batch (grid) axis.  An empty owner chunk (a 0 in ``lead``) is
returned untouched.

A single factor or slice (no lead dims) runs as a bank of one.

There is no counterpart of the TPU plan (``KernelPlan``, ``_pick_block``
and the 12 MiB VMEM budget): the kernels mask ragged edges themselves, so
nothing is padded, and the fused precondition keeps its first product in
device memory rather than in on-chip scratch, so it has no size limit and
takes every 2-D slice.  Tile and shared-memory sizes live in the CUDA
sources alone (the wrapper asks the library for the one scratch size it
needs).  Only a gradient with extra broadcast dims (experts under shared
factors) falls back to :func:`two_sided_precondition` (two ``matmul``
launches plus a rescale); that fallback is counted in
:func:`fallback_counts` and warned about.
"""
from __future__ import annotations

import warnings
from collections import Counter
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import precond as pc
from repro_torch.kernels import rank1_smw as rk

launch_counts = build.launch_counts
reset_launch_counts = build.reset_launch_counts


class KernelFallbackWarning(UserWarning):
    """A fused entry point fell back to its unfused path."""


_FALLBACK_COUNTS: Counter = Counter()


def fallback_counts() -> Dict[Tuple[str, str], int]:
    return dict(_FALLBACK_COUNTS)


def reset_fallback_counts() -> None:
    _FALLBACK_COUNTS.clear()


def _note_fallback(kernel: str, reason: str, detail: str) -> None:
    _FALLBACK_COUNTS[(kernel, reason)] += 1
    warnings.warn(f"{kernel}: falling back to the unfused path ({reason}): "
                  f"{detail}", KernelFallbackWarning, stacklevel=3)


# ----------------------------------------------------------------------- #
# SMW
# ----------------------------------------------------------------------- #
def smw_rank1_update_banked(j: torch.Tensor, v: torch.Tensor, *,
                            gamma: float, variant: str = "paper",
                            out: torch.Tensor = None) -> torch.Tensor:
    """Banked fused SMW.  j: (*lead, d, d); v: (*lead, d).  ``out`` (may
    be ``j``) receives the update in place."""
    d = j.shape[-1]
    lead = tuple(j.shape[:-2])
    if tuple(v.shape) != lead + (d,):
        raise ValueError(f"smw bank {tuple(j.shape)} vs stats "
                         f"{tuple(v.shape)}")
    if not lead:                                    # one factor
        return smw_rank1_update_banked(j[None], v[None], gamma=gamma,
                                       variant=variant)[0]
    if 0 in lead:                                   # empty owner slice
        return j
    jf = j.reshape(-1, d, d)
    vf = v.float().reshape(-1, d).contiguous()
    of = None if out is None else out.view(-1, d, d)
    return rk.fused_smw(jf, vf, gamma=gamma, variant=variant,
                        out=of).reshape(j.shape)


# ----------------------------------------------------------------------- #
# Precondition
# ----------------------------------------------------------------------- #
def two_sided_precondition(l_inv: torch.Tensor, r_inv: torch.Tensor,
                           g_w: torch.Tensor) -> torch.Tensor:
    """ΔW = R⁻¹ G L⁻¹ via two ``matmul`` launches (fp32).  Extra leading
    dims of ``g_w`` broadcast the 2-D factors."""
    lead = tuple(g_w.shape[:-2])
    g3 = g_w.reshape((-1,) + tuple(g_w.shape[-2:])).contiguous()
    t = mm.matmul(r_inv.contiguous(), g3)
    out = mm.matmul(t, l_inv.contiguous())
    return out.reshape(lead + tuple(out.shape[-2:]))


def fused_precondition_banked(l_inv: torch.Tensor, r_inv: torch.Tensor,
                              g_w: torch.Tensor, *,
                              rescale: bool = True) -> torch.Tensor:
    """l_inv (*lead, do, do), r_inv (*lead, di, di), g_w (*lead, *extra,
    di, do) → fp32 ΔW, one ``fused_precond`` launch per bank."""
    lead = tuple(l_inv.shape[:-2])
    if tuple(r_inv.shape[:len(lead)]) != lead or \
            tuple(g_w.shape[:len(lead)]) != lead:
        raise ValueError(f"precondition bank shapes l {tuple(l_inv.shape)} "
                         f"r {tuple(r_inv.shape)} g {tuple(g_w.shape)}")
    if not lead:                                    # one slice
        return fused_precondition_banked(l_inv[None], r_inv[None],
                                         g_w[None], rescale=rescale)[0]
    if 0 in lead:                                   # empty owner slice
        return torch.zeros(g_w.shape, dtype=torch.float32,
                           device=g_w.device)
    lf = l_inv.reshape((-1,) + tuple(l_inv.shape[-2:]))
    rf = r_inv.reshape((-1,) + tuple(r_inv.shape[-2:]))
    gf = g_w.reshape((lf.shape[0],) + tuple(g_w.shape[len(lead):]))
    if gf.ndim > 3:
        # extra broadcast dims: the unfused path with the factors expanded
        # over them, and a rescale spanning the whole slice
        _note_fallback("fused_precond", "extra_dims",
                       f"g_w shape {tuple(g_w.shape)}")
        n_e = gf[0, ..., 0, 0].numel()

        def expand(f):
            return f[:, None].expand((-1, n_e) + tuple(f.shape[-2:])) \
                .reshape((-1,) + tuple(f.shape[-2:]))
        delta = two_sided_precondition(expand(lf), expand(rf), gf.reshape(
            (-1,) + tuple(gf.shape[-2:]))).reshape(gf.shape)
        if rescale:
            delta = pc.rescale_update(delta, gf, n_lead=1)
        return delta.reshape(g_w.shape)
    out = pc.fused_precond(rf.contiguous(), gf.contiguous(), lf.contiguous(),
                           rescale=rescale)
    return out.reshape(g_w.shape)
